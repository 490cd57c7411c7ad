"""Positionwise similarity metric (reference C9: pull_data.cpp:81-127).

Definition: count of positions where the two sequences agree over the
overlap window, normalised by the *maximum* length. The reference chunks
this over std::threads with an atomic accumulator (P7); one vectorised
numpy/jnp reduction replaces all of it. The reference's division-by-zero
crash when thread count exceeds the min length (quirk B11) is not
reproduced.
"""

from __future__ import annotations

import numpy as np

from cse305_parallel_sequence_alignment.core import encode_seq


def sequence_similarity(a, b) -> float:
    a = encode_seq(a) if isinstance(a, (str, bytes)) else np.asarray(a)
    b = encode_seq(b) if isinstance(b, (str, bytes)) else np.asarray(b)
    k = min(a.shape[0], b.shape[0])
    mx = max(a.shape[0], b.shape[0])
    if mx == 0:
        return 0.0
    return float(np.sum(a[:k] == b[:k]) / mx)


def sequence_similarity_batch(a_enc, b_enc, len_a, len_b):
    """Vectorised over a padded batch: (B, La), (B, Lb) uint8 + lengths.

    Padding must differ between a and b (ops/wavefront PAD_A/PAD_B) so
    padded tails never match.
    """
    a_enc = np.asarray(a_enc)
    b_enc = np.asarray(b_enc)
    k = min(a_enc.shape[1], b_enc.shape[1])
    matches = np.sum(a_enc[:, :k] == b_enc[:, :k], axis=1)
    mx = np.maximum(np.asarray(len_a), np.asarray(len_b))
    return matches / np.maximum(mx, 1)
