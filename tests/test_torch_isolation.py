"""repro_torch stands alone: it imports neither JAX nor the reference
package, and its entry points run on the card unless told otherwise."""
import ast
import pathlib
import re
import subprocess
import sys

import pytest
import torch

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _modules():
    return sorted(p for p in PKG.rglob("*.py"))


def test_import_with_jax_blocked_loads_neither_jax_nor_repro():
    names = [".".join(p.relative_to(PKG.parent).with_suffix("").parts) for p in _modules()]
    names = [n[: -len(".__init__")] if n.endswith(".__init__") else n for n in names]
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'jax' or name.startswith(('jax.', 'jaxlib')) or name == 'repro' "
        "or name.startswith('repro.'):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.'))]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_no_jax_or_reference_imports_in_the_source():
    scanned = {p.relative_to(PKG).parts[0] for p in _modules()}
    assert {"core", "kernels", "serve", "sim", "launch", "models", "configs", "bench", "index", "distributed",
            "examples", "data", "train"} <= scanned
    modules = {p.relative_to(PKG).as_posix() for p in _modules()}
    assert {"models/mamba2.py", "kernels/ssd_scan/kernel.py", "kernels/ssd_scan/ops.py",
            "kernels/ssd_scan/ref.py", "index/store.py", "index/priors.py", "core/runtime.py",
            "core/distributed.py", "distributed/fault_tolerance.py", "examples/quickstart.py",
            "bench/async_compose.py", "serve/service.py", "serve/batcher.py", "launch/serve_search.py",
            "launch/serve_http.py", "launch/mesh.py", "distributed/elastic.py", "data/framestore.py",
            "bench/sharded.py", "bench/plan_compose.py", "examples/search_distributed.py",
            "models/detection.py", "examples/serve_detector.py", "train/optimizer.py", "train/checkpoint.py",
            "train/train_step.py", "data/pipeline.py", "launch/train.py",
            "kernels/flash_attention/ops.py"} <= modules
    offenders = []
    for path in _modules():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                if m.split(".")[0] in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.relative_to(PKG)}:{node.lineno} {m}")
    assert not offenders, offenders


def test_entry_points_default_to_the_card():
    """Without a card, the default device is an error, not a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.bench import async_compose, multiquery, plan_compose, savings, sharded
    from repro_torch.examples import quickstart, search_distributed, serve_detector
    from repro_torch.device import resolve
    from repro_torch.launch import search, serve, serve_http, serve_search, train

    with pytest.raises(RuntimeError, match="cuda"):
        resolve()
    with pytest.raises(RuntimeError, match="cuda"):
        search.main(["--scale", "0.02", "--max-steps", "8"])
    with pytest.raises(RuntimeError, match="cuda"):
        search.main(["--scale", "0.02", "--queries", "0", "1", "--plan",
                     '{"queries": 2, "max_steps": 8, "execution": {"queries_axis": true}}'])
    with pytest.raises(RuntimeError, match="cuda"):
        search.main(["--scale", "0.02", "--max-steps", "8", "--detector", "noisy", "--baseline"])
    with pytest.raises(RuntimeError, match="cuda"):
        search.main(["--scale", "0.02", "--plan", '{"max_steps": 8, "cohorts": 4, "execution": {"shards": 4}}'])
    with pytest.raises(RuntimeError, match="cuda"):
        search.main(["--scale", "0.02", "--kill-worker", "1", "--plan",
                     '{"queries": 2, "max_steps": 8, "cohorts": 4, "execution": {"queries_axis": true, "shards": 2}}'])
    with pytest.raises(RuntimeError, match="cuda"):
        sharded.main(["--quick"])
    with pytest.raises(RuntimeError, match="cuda"):
        plan_compose.main(["--quick"])
    with pytest.raises(RuntimeError, match="cuda"):
        search_distributed.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        savings.main(["--quick", "--scale", "0.02"])
    with pytest.raises(RuntimeError, match="cuda"):
        multiquery.main(["--quick"])
    with pytest.raises(RuntimeError, match="cuda"):
        async_compose.main(["--quick"])
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "phi3-medium-14b", "--tokens", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "phi3-medium-14b", "--reduced", "--tokens", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "mamba2-370m", "--tokens", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "phi-3-vision-4.2b", "--tokens", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "whisper-base", "--tokens", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve_detector.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        serve_search.main(["--scale", "0.02"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve_http.main(["--scale", "0.02", "--port", "0"])
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--reduced", "--steps", "1"])
    assert train.build_parser().parse_args([]).device == "cuda"
    assert serve_search.build_parser().parse_args([]).device == "cuda"
    assert resolve("cpu").type == "cpu"


def test_service_fronts_run_on_the_cpu_when_asked(capsys, monkeypatch):
    """The stdin front with ``--device cpu``: one answer a request line,
    EOF drains, the summary on stderr; the HTTP front's parser takes the
    same flags."""
    import io
    import json

    from repro_torch.launch import serve_http, serve_search

    lines = [
        {"op": "submit", "tenant": "a", "class": 0, "seed": 1,
         "plan": {"result_limit": 3, "max_steps": 400, "cohorts": 4, "execution": {"queries_axis": True}}},
        {"op": "submit", "tenant": "big", "class": 1,
         "plan": {"result_limit": 3, "max_steps": 900_000, "cohorts": 4, "execution": {"queries_axis": True}}},
        {"op": "stats"},
    ]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(json.dumps(x) for x in lines) + "\n"))
    serve_search.main(["--device", "cpu", "--scale", "0.02", "--budget-s", "500"])
    out, err = capsys.readouterr()
    answers = [json.loads(line) for line in out.splitlines()]
    assert [a["ok"] for a in answers] == [True, True, True]
    assert answers[0]["state"] == "running" and answers[1]["state"] == "rejected"
    assert "on cpu" in err and "tenant a: finished" in err and "service: clean drain" in err
    ap = serve_http.build_parser()
    ap.add_argument("--port", type=int, default=8080)
    assert ap.parse_args(["--device", "cpu", "--port", "0"]).device == "cpu"


def test_cli_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import search

    search.main(["--device", "cpu", "--scale", "0.02", "--query-class", "7",
                 "--plan", '{"result_limit": 3, "max_steps": 64, "cohorts": 8, "method": "pallas"}'])
    out = capsys.readouterr().out
    assert "lowering=scan method=pallas" in out and "ExSample[scan]" in out


def test_multi_cli_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import search

    search.main(["--device", "cpu", "--scale", "0.02", "--queries", "7", "3", "7",
                 "--plan", '{"queries": 3, "result_limit": 3, "max_steps": 64, "cohorts": 8, '
                           '"method": "pallas", "execution": {"queries_axis": true, "cache": -1}}'])
    out = capsys.readouterr().out
    assert "lowering=multi method=pallas" in out and "ExSample[multi]" in out
    assert "query 2:" in out and "cache hits" in out and "amortization" in out
    with pytest.raises(SystemExit, match="--queries needs a --plan"):
        search.main(["--device", "cpu", "--scale", "0.02", "--queries", "0", "1"])


def test_async_multi_cli_prints_the_merges_line(capsys):
    from repro_torch.launch import search

    search.main(["--device", "cpu", "--scale", "0.02", "--queries", "7", "3",
                 "--plan", '{"queries": 2, "result_limit": 3, "max_steps": 64, "cohorts": 8, '
                           '"execution": {"queries_axis": true, "cache": -1, "async_workers": 2}}'])
    out = capsys.readouterr().out
    assert "lowering=async_multi method=exact" in out and "ExSample[async_multi]" in out
    assert "query 1:" in out and "  merges: " in out and "ring high-water" in out


def test_cli_with_an_index_prints_its_economics(capsys, tmp_path):
    from repro_torch.launch import search

    plan = ('{"queries": 2, "result_limit": 3, "max_steps": 64, "cohorts": 8, "method": "pallas", '
            '"execution": {"queries_axis": true, "cache": -1, "index": {"path": "%s"}}}' % tmp_path)
    for _ in range(2):
        search.main(["--device", "cpu", "--scale", "0.02", "--queries", "7", "3", "--plan", plan])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("  index:")]
    (cold_hits, cold_kept), (warm_hits, warm_kept) = [
        [int(v.replace(",", "")) for v in re.findall(r"([\d,]+) (?:index hits|detections persisted)", line)]
        for line in lines]
    assert cold_hits == 0 and cold_kept > 0
    assert warm_hits > 0 and warm_kept == 0


def test_mesh_cli_runs_on_the_cpu_when_asked(capsys):
    """A plan with shards lowers to the mesh kinds and, with ``--device
    cpu``, runs on a CPU mesh."""
    from repro_torch.launch import search

    search.main(["--device", "cpu", "--scale", "0.02", "--plan",
                 '{"result_limit": 5, "max_steps": 32, "cohorts": 8, "execution": {"shards": 4, "sync_every": 2}}'])
    out = capsys.readouterr().out
    assert "lowering=sharded method=wilson_hilferty" in out and "mesh(4,)" in out and "'cpu'" in out
    assert "ExSample[sharded]" in out and "  merges: " in out
    search.main(["--device", "cpu", "--scale", "0.02", "--queries", "7", "3", "--plan",
                 '{"queries": 2, "result_limit": 3, "max_steps": 16, "cohorts": 8, '
                 '"execution": {"queries_axis": true, "shards": 2, "cache": -1}}'])
    out = capsys.readouterr().out
    assert "lowering=multi_sharded" in out and "ExSample[multi_sharded]" in out and "query 1:" in out

