"""What the command and the reference load, and the command's refusal without a card."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

REFERENCE = """
import sys, torch
torch.set_num_threads(2)
from portbench.tests.tiny import tiny_cell
from portbench import generator
from portbench.reference.pipeline import Precision
cell = tiny_cell()
bodies = [generator.request(5, 0, cell["mix"])]
out = cell["family"].reference(cell["spec"], 5, bodies, "cpu", Precision.of(cell["spec"]))
assert out[0].pixels.shape == (1, 64, 64, 3)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""

HARNESS = """
import sys, torch
torch.set_num_threads(2)
import flux_fp8_api_tpu_torch.models.flux as flux
flux.COMPILE_BACKEND = "aot_eager"
from portbench.tests.tiny import stdlib_serve, tiny_cell
from portbench import run
res = run.run_cell(tiny_cell(), 3, seconds=0.2, trace=False, device="cpu", serve=stdlib_serve)
assert res["correct"], res
print(sorted({m.split(".")[0] for m in sys.modules}))
"""

FORBIDDEN = {"jax", "jaxlib", "flax", "flux_fp8_api_tpu"}


def loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))


def test_reference_loads_nothing_of_the_program_or_jax():
    mods = loaded(REFERENCE)
    assert not mods & (FORBIDDEN | {"flux_fp8_api_tpu_torch"})


def test_harness_loads_no_jax_and_not_the_jax_package():
    mods = loaded(HARNESS)
    assert "flux_fp8_api_tpu_torch" in mods and not mods & FORBIDDEN


def test_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "dev-1024", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                                           "HOME": str(ROOT / "build")})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_command_fails_without_the_program(tmp_path):
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "dev-1024", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
