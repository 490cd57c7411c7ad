"""CLI surface (__main__.py)."""

import json


from cse305_parallel_sequence_alignment.__main__ import main


def test_cli_align(capsys):
    assert main(["align", "--a", "AGGA", "--b", "AGTGC"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == ["AG-GA", "AGTGC"]


def test_cli_local(capsys):
    assert main(["local", "--a", "GGGACGTACGTGGG",
                 "--b", "TTTACGTACGTTTT"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["score"] == 16.0
    assert rec["cigar"] == "8M"
    assert rec["query_span"] == [4, 11]


def test_cli_partition(capsys):
    assert main(["partition", "--a", "ACGTACGTAC", "--b", "ACGTACCTAC",
                 "--p", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and len(out[0]) == len(out[1])


def test_cli_info(capsys):
    assert main(["info"]) == 0
    rec = json.loads(capsys.readouterr().out)
    assert rec["backend"] == "cpu" and len(rec["devices"]) == 8


def test_cli_longscore(capsys):
    assert main(["longscore", "--a", "ACGTACGTAC", "--b", "ACGTACCTAC",
                 "--row-chunk", "4"]) == 0
    rec = json.loads(capsys.readouterr().out)
    from cse305_parallel_sequence_alignment.models.oracle import (
        oracle_align,
    )
    assert rec["score"] == oracle_align("ACGTACGTAC", "ACGTACCTAC").score
    assert rec["devices"] == 8


def test_cli_experiment_input_size(tmp_path, capsys):
    assert main(["experiment", "input-size", "--out-dir", str(tmp_path),
                 "--test-pairs", "2"]) == 0
    body = (tmp_path / "input_size_testing.csv").read_text().splitlines()
    assert body[0] == "Testing with different input sizes"
    assert body[1] == "Test number,Input size,Execution time"
    assert len(body) == 4
