"""synth11 through the port's launcher against the reference C++
binary's recorded run; the checks and tolerances are those of
``tests/test_torch_h2h.py``, which runs synth7 (one log per file, so the
test workers run the two side by side)."""
from tests.test_torch_h2h import check_against_the_binary, run_log


def test_synth11_meets_the_reference_binary(tmp_path):
    r, _ = run_log(11, tmp_path)
    assert (r["reference"]["nodes"], r["reference"]["loop_edges"]) == (92, 8)
    check_against_the_binary(r)
