"""Rank processes of the port's mesh tests (tests/test_torch_mesh*.py).

Each world is a set of processes that import torch and the port only, never JAX or
the JAX package; they meet over gloo through a FileStore in the job's directory.

    python -m tests.torch_mesh_worker <job dir> <rank> <world>

The test writes ``job.pkl`` (the mesh and a list of tasks, each a scenario's name and
its numpy inputs); every rank runs the tasks in order and writes ``out<rank>.pkl`` (one
result per task: numpy arrays and plain values). :func:`run_worlds` starts several
worlds at once, waits with a timeout of its own (a deadlock fails one test, not the
suite) and returns the ranks' outputs.
"""

import copy
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def world_size(mesh: dict) -> int:
    return int(np.prod(list(mesh.values())))


def run_worlds(root: Path, jobs: dict, timeout: float = 120.0) -> dict:
    """Run every ``jobs[name]`` (``{"mesh": …, "tasks": [(scenario, args), …]}``) on its
    own world, all at once → ``{name: [rank 0's results, rank 1's, …]}``, each a list
    with one result per task."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    started = {}
    for name, job in jobs.items():
        job_dir = Path(root) / name
        job_dir.mkdir(parents=True, exist_ok=True)
        with open(job_dir / "job.pkl", "wb") as f:
            pickle.dump(job, f)
        started[name] = (job_dir, [
            subprocess.Popen([sys.executable, "-m", "tests.torch_mesh_worker", str(job_dir), str(r),
                              str(world_size(job["mesh"]))],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world_size(job["mesh"]))
        ])
    deadline = time.monotonic() + timeout
    try:
        logs = {}
        for name, (_, procs) in started.items():
            logs[name] = []
            for p in procs:
                try:
                    out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
                except subprocess.TimeoutExpired:
                    raise AssertionError(f"world {name} {jobs[name]['mesh']} did not finish in {timeout} s")
                logs[name].append(out.decode(errors="replace"))
    finally:
        for _, procs in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    results = {}
    for name, (job_dir, procs) in started.items():
        for r, (p, log) in enumerate(zip(procs, logs[name])):
            if p.returncode != 0:
                raise AssertionError(f"rank {r} of world {name} {jobs[name]['mesh']} failed:\n{log[-4000:]}")
        results[name] = []
        for r in range(len(procs)):
            with open(job_dir / f"out{r}.pkl", "rb") as f:
                results[name].append(pickle.load(f))
    return results


# ------------------------------------------------------------------------ helpers


def np_(t):
    """torch → numpy with the same bytes (bf16/fp8 as their integer views)."""
    import torch

    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8).numpy()
    return t.numpy()


def leaf_fields(tree) -> dict:
    """{dotted path: {field: numpy}} of every Linear of a tree."""
    from flux_fp8_api_tpu_torch.ops.quant import Linear

    out = {}
    for name, m in tree.named_modules():
        if isinstance(m, Linear):
            out[name] = {k: np_(v) for k, v in m._buffers.items() if v is not None}
            out[name]["kind"] = m.kind
    return out


def flux_inputs(job):
    import torch

    x = job["inputs"]
    t = lambda a: torch.from_numpy(np.array(a, order="C"))  # noqa: E731
    return (t(x["img"]), t(x["img_ids"]), t(x["txt"]), t(x["txt_ids"]), t(x["t"]), t(x["y"]),
            t(x["g"]) if x.get("g") is not None else None)


def flux_model(job):
    from flux_fp8_api_tpu_torch.models.flux import FluxStatic
    from flux_fp8_api_tpu_torch.utils.config import FluxParams
    from flux_fp8_api_tpu_torch.utils.convert import convert

    cfg = FluxStatic.from_params(FluxParams(**job["flux_params"]), compute_dtype=job["dtype"],
                                 use_pallas=job.get("use_pallas", True))
    return convert(job["tree"]), cfg


def _rows(mesh, xs):
    rows = mesh.batch_rows(xs[0].shape[0])
    return xs if rows is None else tuple(None if x is None else x[rows] for x in xs), rows


def plant_bias_fault(model, mesh) -> None:
    """A sharding fault for the tests to see: every row-parallel flow Linear's bias
    added on each tp rank (tp times in the reduced sum) instead of once."""
    import torch

    from flux_fp8_api_tpu_torch.ops.quant import Linear

    with torch.inference_mode():
        for m in model.modules():
            if isinstance(m, Linear) and m.shard is not None and m.shard.mode == "row" and m.bias is not None:
                m.bias.mul_(mesh.size("tp"))


# ---------------------------------------------------------------------- scenarios


def scenario_flux(mesh, job):
    """The forward on the mesh, this rank's shards and the collective count per
    evaluation (with ``plant`` "bias", of :func:`plant_bias_fault`); with ``calibrate``, the input scales frozen from one calibration
    forward with the amaxes reduced over the mesh (``in_scales``) and without
    (``local_in_scales``)."""
    import torch

    from flux_fp8_api_tpu_torch.calibration import apply_input_scales, reduce_amaxes
    from flux_fp8_api_tpu_torch.models.flux import flux_apply
    from flux_fp8_api_tpu_torch.parallel import mesh as pmesh

    model, cfg = flux_model(job)
    model, cfg = pmesh.setup_flux(model, cfg, mesh)
    if job.get("plant") == "bias":
        plant_bias_fault(model, mesh)
    xs, rows = _rows(mesh, flux_inputs(job))
    out = {"shards": leaf_fields(model), "cfg": {"use_pallas": cfg.use_pallas, "layout": cfg.fused_layout,
                                                 "seq": cfg.attn_seq_axis, "axes": cfg.attn_shard_axes}}
    with torch.inference_mode():
        pmesh.reset_collectives()
        pred = flux_apply(model, cfg, *xs)
        out["collectives"] = dict(pmesh.COLLECTIVES)
        if rows is not None:
            pred = mesh.all_gather(pred, "dp", dim=0)
        out["pred"] = pred.float().numpy()
        if job.get("calibrate"):
            _, amaxes = flux_apply(model, cfg, *xs, collect_amax=True)
            for key, reduced in (("local_in_scales", amaxes), ("in_scales", reduce_amaxes(amaxes, mesh))):
                apply_input_scales(model, reduced)
                out[key] = {k: v["in_scale"] for k, v in leaf_fields(model).items() if "in_scale" in v}
    return out


def scenario_dynamic(mesh, job):
    """The dynamic step cache with the batch rows split over dp: the evaluations and
    the latents with the drift reduced over dp, and the evaluations of this rank's
    rows alone (``local_evals``, the drift not reduced; no collective runs then)."""
    import torch

    from flux_fp8_api_tpu_torch.parallel import mesh as pmesh
    from flux_fp8_api_tpu_torch.sampling import CacheConfig, denoise

    model, cfg = flux_model(job)
    model, cfg = pmesh.setup_flux(model, cfg, mesh)
    img, img_ids, txt, txt_ids, _, y, _ = flux_inputs(job)
    (img, img_ids, txt, txt_ids, y), rows = _rows(mesh, (img, img_ids, txt, txt_ids, y))
    out = {}
    with torch.inference_mode():
        for key, dp_mesh in (("local", None), ("reduced", mesh)):
            stats = {}
            lat = denoise(model, cfg, img, img_ids, txt, txt_ids, y, job["timesteps"], 3.5,
                          cache=CacheConfig(**job["cache"]), stats=stats, dp_mesh=dp_mesh)
            out[f"{key}_evals"] = stats["model_evals"]
        out["latents"] = mesh.all_gather(lat, "dp", dim=0).float().numpy()
    return out


def scenario_lora(mesh, job):
    """A LoRA fused into this rank's shards: the fused leaves and the forward."""
    import torch

    from flux_fp8_api_tpu_torch.lora import fuse_lora
    from flux_fp8_api_tpu_torch.models.flux import flux_apply
    from flux_fp8_api_tpu_torch.parallel import mesh as pmesh

    model, cfg = flux_model(job)
    model, cfg = pmesh.setup_flux(model, cfg, mesh)
    sd = {k: torch.from_numpy(v) for k, v in job["lora"].items()}
    keys = sorted({k.rsplit(".lora_", 1)[0] for k in sd if ".lora_" in k})
    with torch.inference_mode():
        fuse_lora(model, cfg, sd, keys, job.get("scale", 1.0))
        pred = flux_apply(model, cfg, *flux_inputs(job))
    return {"shards": leaf_fields(model), "pred": pred.float().numpy()}


def scenario_encoders(mesh, job):
    """T5 and CLIP sharded over tp at one weight-only tier: this rank's shards and the
    encodings."""
    import torch

    from flux_fp8_api_tpu_torch.models.clip import CLIPConfig, clip_encode
    from flux_fp8_api_tpu_torch.models.t5 import T5Config, t5_encode
    from flux_fp8_api_tpu_torch.parallel import mesh as pmesh
    from flux_fp8_api_tpu_torch.utils.convert import convert

    out = {}
    ids = torch.from_numpy(job["ids"])
    with torch.inference_mode():
        for name, cfg_cls, enc in (("t5", T5Config, t5_encode), ("clip", CLIPConfig, clip_encode)):
            cfg = cfg_cls(**job[f"{name}_cfg"])
            params = convert(job[name])
            pmesh.reset_collectives()
            pmesh.shard_encoder_params(params, mesh, num_heads=cfg.num_heads)
            res = enc(params, cfg, ids[:, : job[f"{name}_len"]], torch.float32)
            out[name] = {"shards": leaf_fields(params), "out": np_(res[1] if name == "clip" else res),
                         "collectives": dict(pmesh.COLLECTIVES)}
    return out


def scenario_pipeline(mesh, job):
    """A tiny ``generate`` through FluxPipeline on the mesh from fixed noise, schedule
    and conditioning; then ``save_prequantized``."""
    import torch

    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
    from flux_fp8_api_tpu_torch.utils.config import ModelSpec

    from flux_fp8_api_tpu_torch.parallel import mesh as pmesh
    from flux_fp8_api_tpu_torch.utils.convert import convert

    model, cfg = flux_model(job)
    pipe = FluxPipeline("flux-dev", model=model, model_cfg=cfg, ae=convert(job["ae"]),
                        config=ModelSpec(**job["spec"]), prequantized=job.get("prequantized", False), mesh=mesh)
    noise = torch.from_numpy(job["noise"])
    vec, txt = torch.from_numpy(job["vec"]), torch.from_numpy(job["txt"])
    pipe.preprocess_latent = lambda *a, **kw: (noise.clone(), list(job["timesteps"]))
    pipe._encode_prompts = lambda prompts: {p: (vec, txt) for p in prompts}
    out = {"cfg": {"layout": pipe.model_cfg.fused_layout, "seq": pipe.model_cfg.attn_seq_axis,
                   "use_pallas": pipe.model_cfg.use_pallas},
           "flow_bytes": pmesh.sharded_bytes(pipe.model_params)}
    for i, gen in enumerate(job["generates"]):
        jpeg = pipe.generate(prompt="a cat", silent=True, **gen)
        out[f"latents{i}"] = pipe.last_latents.float().numpy()
        out[f"jpeg{i}"] = None if jpeg is None else jpeg.getvalue()
    if job.get("save"):
        pipe.save_prequantized(job["save"])
    return out


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_flux, scenario_dynamic, scenario_lora, scenario_encoders, scenario_pipeline)}


def main(argv) -> None:
    job_dir, rank, world = Path(argv[0]), int(argv[1]), int(argv[2])
    import torch

    torch.set_num_threads(1)
    with open(job_dir / "job.pkl", "rb") as f:
        job = pickle.load(f)
    from flux_fp8_api_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(job["mesh"], backend="gloo", device="cpu", init_method=f"file://{job_dir}/store",
                     rank=rank, world_size=world)
    out = [SCENARIOS[name](mesh, copy.deepcopy(args)) for name, args in job["tasks"]]
    with open(job_dir / f"out{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
