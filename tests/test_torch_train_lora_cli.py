"""The port's LoRA trainer CLI (``flux_fp8_api_tpu_torch.train_lora``) and training bench
(``bench_train``) on the CPU, on ``configs/config-tiny-cpu.json``, mirroring
tests/test_train_lora_cli.py: the dataset listing and the flags against the JAX CLI's,
a train whose file reloads through the pipeline's LoRA path, resume and validation,
and a resume mid-epoch that equals the uninterrupted run bit for bit (the per-step
generators and the fast-forwarded data order make it a continuation, and the state
file restores the adapters and AdamW's moments exactly).
"""

import json
import logging
import os

import numpy as np
import pytest
import torch
from PIL import Image

from flux_fp8_api_tpu import train_lora as jax_cli
from flux_fp8_api_tpu_torch import bench_train
from flux_fp8_api_tpu_torch import train_lora as cli
from flux_fp8_api_tpu_torch.parallel.train import STATE_FILE
from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
from flux_fp8_api_tpu_torch.utils.safetensors_io import load_safetensors

torch.set_num_threads(1)

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "config-tiny-cpu.json")


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora_data")
    rng = np.random.default_rng(0)
    for stem in ["red_fox", "blue_bird"]:
        Image.fromarray(rng.integers(0, 255, (80, 96, 3), dtype=np.uint8)).save(d / f"{stem}.png")
    (d / "red_fox.txt").write_text("a (red:1.2) fox in snow")  # one caption file, one stem
    (d / "notes.md").write_text("not an image")
    return str(d)


def image_dir(path, n, seed):
    rng = np.random.default_rng(seed)
    path.mkdir()
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(path / f"item_{i}.png")
    return str(path)


def test_list_examples_matches_jax(dataset_dir, tmp_path):
    pairs = cli.list_examples(dataset_dir)
    assert pairs == jax_cli.list_examples(dataset_dir)
    assert {os.path.basename(p): c for p, c in pairs} == {
        "blue_bird.png": "blue bird", "red_fox.png": "a (red:1.2) fox in snow"}
    with pytest.raises(ValueError, match="no images"):
        cli.list_examples(str(tmp_path))


def test_flags_and_defaults_match_jax():
    required = ["--config-path", "c.json", "--data-dir", "d", "--output", "o.safetensors"]
    assert vars(cli.parse_args(required)) == vars(jax_cli.parse_args(required))
    flags = required + ["--rank", "4", "--steps", "9", "--lr", "0.01", "--batch-size", "2", "--width", "64",
                        "--height", "32", "--seed", "3", "--save-every", "2", "--no-remat", "--state-dir", "s",
                        "--val-every", "5", "--t-sampling", "uniform"]
    assert vars(cli.parse_args(flags)) == vars(jax_cli.parse_args(flags))


def test_train_and_reload(dataset_dir, tmp_path):
    """rank 2, 3 steps at batch 2 with a checkpoint at step 2: the file is a kohya
    rank-2 LoRA over the default targets, and it loads through the pipeline's LoRA
    path and changes the image."""
    out = str(tmp_path / "tiny_lora.safetensors")
    result = cli.train(["--config-path", CONFIG, "--data-dir", dataset_dir, "--output", out, "--rank", "2",
                        "--steps", "3", "--lr", "1e-3", "--batch-size", "2", "--width", "64", "--height", "64",
                        "--save-every", "2"])
    assert result == out and os.path.exists(out)
    sd = load_safetensors(out)
    assert sd["lora_unet_double_blocks_0_img_attn_qkv.lora_down.weight"].shape == (2, 64)
    assert float(sd["lora_unet_single_blocks_2_linear2.alpha"]) == 2.0
    assert any(float(v.abs().max()) > 0 for k, v in sd.items() if "lora_up" in k)

    pipe = FluxPipeline.load_pipeline_from_config_path(CONFIG)
    before = pipe.generate(prompt="a red fox", width=64, height=64, num_steps=1, seed=7, silent=True).getvalue()
    pipe.load_lora(out, scale=1.0)
    after = pipe.generate(prompt="a red fox", width=64, height=64, num_steps=1, seed=7, silent=True).getvalue()
    assert before != after


def test_resume_and_validation(tmp_path, caplog):
    """--state-dir holds one state file after the run; --val-every reports the
    held-out loss (5 images, so one is held out), the same number at the same step of a
    resumed run; a resume at its last step trains nothing and writes the file again."""
    data = image_dir(tmp_path / "data", 5, 1)
    out, state = str(tmp_path / "lora.safetensors"), str(tmp_path / "state")
    common = ["--config-path", CONFIG, "--data-dir", data, "--output", out, "--rank", "2", "--lr", "1e-3",
              "--width", "64", "--height", "64", "--state-dir", state, "--val-every", "2"]
    with caplog.at_level(logging.INFO, logger="flux_fp8_api_tpu_torch.train_lora"):
        cli.train(common + ["--steps", "2", "--save-every", "2"])
    vals = [r.getMessage() for r in caplog.records if "val loss" in r.getMessage()]
    assert len(vals) == 1 and vals[0].startswith("step 2")
    assert os.listdir(state) == [STATE_FILE]
    first = open(out, "rb").read()
    os.remove(out)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="flux_fp8_api_tpu_torch.train_lora"):
        cli.train(common + ["--steps", "2"])
    assert any("@ step 2" in r.getMessage() for r in caplog.records)
    assert not any("val loss" in r.getMessage() for r in caplog.records)
    assert open(out, "rb").read() == first


def test_resume_mid_epoch_matches_uninterrupted(tmp_path):
    """3 examples at batch 1: a checkpoint at step 2 is mid-epoch; resumed to step 4 it
    crosses the reshuffle and writes the uninterrupted run's file, bit for bit."""
    data = image_dir(tmp_path / "data", 3, 2)
    common = ["--config-path", CONFIG, "--data-dir", data, "--rank", "2", "--lr", "1e-3",
              "--width", "64", "--height", "64", "--batch-size", "1"]
    straight = str(tmp_path / "straight.safetensors")
    cli.train(common + ["--output", straight, "--steps", "4"])
    resumed, state = str(tmp_path / "resumed.safetensors"), str(tmp_path / "state")
    cli.train(common + ["--output", resumed, "--steps", "2", "--state-dir", state])
    cli.train(common + ["--output", resumed, "--steps", "4", "--state-dir", state])
    a, b = load_safetensors(straight), load_safetensors(resumed)
    assert sorted(a) == sorted(b) and a
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_bench_train_tiny_prints_its_line(capsys):
    report = bench_train.main(["int4", "--tiny"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(report))
    assert report["unit"] == "s/step" and report["value"] > 0 and "int4" in report["metric"]
    assert report["detail"]["device"] == "cpu" and np.isfinite(report["detail"]["final_loss"])
    assert report["detail"]["steps_per_s"] == pytest.approx(1.0 / report["value"])
