"""What the benchmark may load and where it may write: no JAX-side module
in the harness's process (top-level names compared whole), nothing of the
program in the references, no fixed path under /tmp or /dev/shm, and a
run's files only under TMPDIR (removed at its end) and the checkout."""

import ast
import json
import os
import subprocess
import sys

from port_bench import core

BENCH = core.BENCH_DIR
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "egm_unet_tpu")


def run_py(code: str, env=None) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=str(core.ROOT), env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_harness_and_what_it_drives_load_nothing_of_jax():
    metrics = sorted(p.stem for p in (BENCH / "metrics").glob("*.py")
                     if p.stem not in ("__init__", "lib"))
    drivers = sorted(p.stem for p in (BENCH / "drivers").glob("*.py") if p.stem != "__init__")
    code = f"""
import importlib, json, sys
sys.path.insert(0, '.')
import port_bench.run, port_bench.control
from port_bench import core
for m in {metrics!r}:
    core.reader(m)
for d in {drivers!r}:
    importlib.import_module('port_bench.drivers.' + d)
for m in ('egm_unet_torch.serving',
          'egm_unet_torch.cli.eval_clipseg', 'egm_unet_torch.models.clipseg',
          'egm_unet_torch.utils.checkpoint', 'egm_unet_torch.ops.cuda.build'):
    importlib.import_module(m)
print(json.dumps(sorted(sys.modules)))
"""
    loaded = json.loads(run_py(code).strip().splitlines()[-1])
    assert not [m for m in loaded if m.split(".", 1)[0] in FORBIDDEN]
    assert "egm_unet_torch" in loaded  # the comparison runs where the program is loaded


def test_forbidden_names_are_compared_whole():
    assert "egm_unet_tpu" in core.FORBIDDEN
    sys.modules["egm_unet_tpu_like_but_not"] = sys
    try:
        assert "egm_unet_tpu_like_but_not" not in core.forbidden_modules()
    finally:
        del sys.modules["egm_unet_tpu_like_but_not"]


def test_references_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".", 1)[0]
                assert top not in ("egm_unet_torch",) + FORBIDDEN, f"{path.name} imports {n}"
    loaded = json.loads(run_py(
        "import json, sys; sys.path.insert(0, '.');"
        "import port_bench.reference.unet, port_bench.reference.clipseg, "
        "port_bench.reference.pipeline; print(json.dumps(sorted(sys.modules)))"
    ).strip().splitlines()[-1])
    assert not [m for m in loaded if m.split(".", 1)[0] in ("egm_unet_torch",) + FORBIDDEN]


def test_no_fixed_scratch_paths_in_the_sources():
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "/tmp" not in text and "/dev/shm" not in text, path


def test_a_run_writes_under_tmpdir_and_cleans_up(tmp_path):
    tmp, home = tmp_path / "tmp", tmp_path / "home"
    tmp.mkdir()
    home.mkdir()
    env = dict(os.environ, TMPDIR=str(tmp), HOME=str(home), XDG_CACHE_HOME=str(home / ".cache"))
    before = sorted(p for p in BENCH.rglob("*") if "__pycache__" not in p.parts)
    shm = set(os.listdir("/dev/shm")) if os.path.isdir("/dev/shm") else set()
    code = """
import json, sys, time
sys.path.insert(0, '.')
from port_bench import core
from port_bench.tests.test_bench_rehearsal import TINY
for name in ('egm_unet.bucket_b32', 'clipseg_fusion.folder_f32'):
    core.run_cell(core.load_cell(name, TINY[name]), 5, 1.0, False, 'cpu',
                  time.perf_counter(), log=lambda *a: None)
io = dict(l.split(': ') for l in open('/proc/self/io').read().splitlines())
print(json.dumps(int(io['write_bytes'])))
"""
    written = json.loads(run_py(code, env).strip().splitlines()[-1])
    assert written < 2 * 2 ** 30
    assert list(tmp.iterdir()) == []
    after = sorted(p for p in BENCH.rglob("*") if "__pycache__" not in p.parts)
    assert before == after
    if shm:
        assert not [n for n in set(os.listdir("/dev/shm")) - shm if "port_bench" in n]
