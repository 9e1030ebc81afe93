"""egm_unet_torch and chip_smoke.py import nothing of JAX, flax or the JAX
package: an AST scan of every source, and a fresh interpreter that imports
every module of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "egm_unet_tpu")
SOURCES = sorted((ROOT / "egm_unet_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif isinstance(node, ast.Call):
            f = node.func
            name = getattr(f, "id", None) or getattr(f, "attr", None)
            if (name in ("__import__", "import_module") and node.args
                    and isinstance(node.args[0], ast.Constant)):
                yield str(node.args[0].value)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_out():
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in (ROOT / "egm_unet_torch").rglob("*.py"))
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_training_slice_modules_are_scanned():
    """The training slice's modules are among the scanned sources (the scan
    globs the package, so a new module is covered as it lands)."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for mod in ("losses.py", "metrics.py", "ops/stencil.py", "engine/schedule.py",
                "engine/state.py", "engine/train.py", "data/loader.py",
                "utils/checkpoint.py", "utils/logging.py", "utils/seeding.py",
                "cli/train.py"):
        assert f"egm_unet_torch/{mod}" in names, mod


def test_text_branch_modules_are_scanned():
    """The text branch's training modules and the RN tower are scanned."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for mod in ("engine/clipseg_train.py", "engine/clipseg_metrics.py",
                "engine/longclip_train.py", "data/phrasecut.py", "data/blend.py",
                "data/fewshot.py", "data/fewshot_splits.py", "config.py",
                "cli/train_clipseg.py", "cli/train_longclip.py", "models/clip/resnet.py"):
        assert f"egm_unet_torch/{mod}" in names, mod


def test_parallel_modules_are_scanned():
    """The parallel package (data, spatial and tensor parallelism) is among
    the scanned sources."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for mod in ("parallel/__init__.py", "parallel/mesh.py", "parallel/halo.py",
                "parallel/tp.py"):
        assert f"egm_unet_torch/{mod}" in names, mod


def test_tail_modules_are_scanned():
    """The converters, the offline tools, the unwired modules, VITDensePredT
    and the native BPE loader are scanned."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for mod in ("utils/convert_unet.py", "utils/colormap.py", "utils/profiling.py",
                "cli/convert.py", "cli/evaluating_indicator.py", "cli/dataset_audit.py",
                "cli/compute_mean_std.py", "nn/extra.py", "models/vitseg.py",
                "native/__init__.py"):
        assert f"egm_unet_torch/{mod}" in names, mod
