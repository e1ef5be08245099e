"""The port's quickstart (``repro_torch.examples.quickstart``) against the
reference's ``examples/quickstart.py``, on the CPU.

Both print the same lines.  The ExSample search of the first part runs
the plan's default ``"auto"`` sampler, the exact Gamma, which the port
holds only statistically, so its numbers are checked for shape and sense;
random+ and the repository are deterministic and must equal the
reference's.  The warm restart must call the detector on no frame, with
every frame the cold run detected persisted and served as an index hit.
"""
import importlib.util
import pathlib
import re

import pytest

from repro_torch.examples import quickstart

REFERENCE = pathlib.Path(__file__).resolve().parents[1] / "examples" / "quickstart.py"
NUMBER = re.compile(r"\d[\d,]*(\.\d+)?")


def _shape(line: str) -> str:
    return NUMBER.sub("N", line)


@pytest.fixture(scope="module")
def outputs():
    import contextlib
    import io

    spec = importlib.util.spec_from_file_location("reference_quickstart", REFERENCE)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref.main()
    port_buf = io.StringIO()
    with contextlib.redirect_stdout(port_buf):
        port = quickstart.main(["--device", "cpu"])
    return buf.getvalue().splitlines(), port_buf.getvalue().splitlines(), port


def test_the_port_prints_the_references_lines(outputs):
    ref_lines, port_lines, _ = outputs
    assert [_shape(x) for x in port_lines if not x.startswith("recall trace")] == \
        [_shape(x) for x in ref_lines if not x.startswith("recall trace")]
    # the deterministic lines are the reference's, number for number
    for prefix in ("repository:", "random+"):
        assert [x for x in port_lines if x.startswith(prefix)] == [x for x in ref_lines if x.startswith(prefix)]
    assert any(x.startswith("recall trace (frames, results): [(200, ") for x in port_lines)


def test_the_search_and_the_warm_restart(outputs):
    _, _, port = outputs
    res = port["exsample"]
    assert res.kind == "scan" and res.results[0] == 40
    assert 0 < res.stats.frames_sampled < port["randomplus"][1]
    cold, warm = port["cold"], port["warm"]
    assert cold.kind == warm.kind == "multi"
    assert warm.stats.detector_invocations == 0
    assert cold.stats.persisted_detections == cold.stats.detector_invocations == warm.stats.index_hits > 0
    assert warm.steps == cold.steps and warm.results == cold.results == (40,)


def test_the_port_quickstart_needs_the_card_unless_told():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart.main([])
