"""The port stands alone: it imports neither JAX nor the JAX package, and
every kernel that ``PERF.md`` marks as ported has a CUDA source."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_importing_the_port_loads_no_jax():
    mods = sorted("repro_torch." + ".".join(p.relative_to(PORT).with_suffix("")
                                            .parts).removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _kernel_table():
    """Rows of the TPU-kernel table in PERF.md as dicts keyed by header."""
    lines = (ROOT / "PERF.md").read_text().splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("| # | TPU kernel"))
    header = [c.strip() for c in lines[start].strip("|").split("|")]
    rows = []
    for ln in lines[start + 2:]:
        if not ln.startswith("|"):
            break
        cells = [c.strip() for c in ln.strip("|").split("|")]
        rows.append(dict(zip(header, cells)))
    return rows


def test_every_ported_kernel_row_has_a_cuda_source():
    rows = _kernel_table()
    assert len(rows) == 17
    ported = [r for r in rows if r["status"].startswith("ported")]
    assert {r["TPU kernel"].split("`")[1] for r in ported} >= {
        "pad_cast", "unpad_cast", "sbgemv_n_complex", "sbgemv_th_complex",
        "sbgemm_n_complex", "sbgemm_th_complex", "sbgemm_gram_complex",
        "sbgemm_n_complex_tiled", "sbgemm_th_complex_tiled",
        "sbgemm_gram_tiled", "sbgemv_n_real", "sbgemv_th_real",
        "sbgemm_n_real", "sbgemm_th_real", "sbgemm_n_real_tiled",
        "sbgemm_th_real_tiled", "flash_attention_bh"}
    for r in ported:
        src = r["port source"].strip("`")
        assert src.endswith(".cu") and (ROOT / src).is_file(), r
    for r in rows:
        assert r["status"].startswith(("ported", "queued")), r
