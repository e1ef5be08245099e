"""repro_torch stands alone: it imports neither JAX nor the reference
package, and its entry points run on the card unless told otherwise."""
import ast
import pathlib
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
    assert {"core", "kernels", "serve", "sim", "launch", "models", "configs", "bench"} <= scanned
    modules = {p.relative_to(PKG).as_posix() for p in _modules()}
    assert {"models/mamba2.py", "kernels/ssd_scan/kernel.py", "kernels/ssd_scan/ops.py",
            "kernels/ssd_scan/ref.py"} <= modules
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
    from repro_torch.bench import multiquery, savings
    from repro_torch.device import resolve
    from repro_torch.launch import search, serve

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
        savings.main(["--quick", "--scale", "0.02"])
    with pytest.raises(RuntimeError, match="cuda"):
        multiquery.main(["--quick"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "phi3-medium-14b", "--tokens", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "phi3-medium-14b", "--reduced", "--tokens", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "mamba2-370m", "--tokens", "1"])
    assert resolve("cpu").type == "cpu"


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
