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
    return start_worlds(root, jobs, timeout)()


def start_worlds(root: Path, jobs: dict, timeout: float = 120.0):
    """Start the worlds of :func:`run_worlds` and return at once → a function that
    waits for them and returns their results (the caller computes its references
    meanwhile)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    started = {}
    for name, job in jobs.items():
        job_dir = Path(root) / name
        job_dir.mkdir(parents=True, exist_ok=True)
        with open(job_dir / "job.pkl", "wb") as f:
            pickle.dump(job, f)
        procs = []
        for r in range(world_size(job["mesh"])):
            with open(job_dir / f"log{r}.txt", "wb") as log:  # a file: a full pipe would stall the rank
                procs.append(subprocess.Popen([sys.executable, "-m", "tests.torch_mesh_worker", str(job_dir),
                                               str(r), str(world_size(job["mesh"]))],
                                              cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
        started[name] = (job_dir, procs)
    deadline = time.monotonic() + timeout
    return lambda: _wait(jobs, started, deadline, timeout)


def _wait(jobs: dict, started: dict, deadline: float, timeout: float) -> dict:
    try:
        for name, (_, procs) in started.items():
            for p in procs:
                try:
                    p.wait(timeout=max(deadline - time.monotonic(), 1.0))
                except subprocess.TimeoutExpired:
                    raise AssertionError(f"world {name} {jobs[name]['mesh']} did not finish in {timeout} s")
    finally:
        for _, procs in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    results = {}
    for name, (job_dir, procs) in started.items():
        for r, p in enumerate(procs):
            if p.returncode != 0:
                log = (job_dir / f"log{r}.txt").read_text(errors="replace")
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
    try:
        pipe = FluxPipeline("flux-dev", model=model, model_cfg=cfg, ae=convert(job["ae"]),
                            config=ModelSpec(**job["spec"]), prequantized=job.get("prequantized", False),
                            mesh=mesh)
    except ValueError as e:  # a refusal at construction, for the test to read
        if not job.get("expect_error"):
            raise
        return {"error": str(e)}
    noise = torch.from_numpy(job["noise"])
    vec, txt = torch.from_numpy(job["vec"]), torch.from_numpy(job["txt"])
    pipe.preprocess_latent = lambda *a, **kw: (noise.clone(), list(job["timesteps"]))
    pipe._encode_prompts = lambda prompts: {p: (vec, txt) for p in prompts}
    out = {"cfg": {"layout": pipe.model_cfg.fused_layout, "seq": pipe.model_cfg.attn_seq_axis,
                   "use_pallas": pipe.model_cfg.use_pallas},
           "flow_bytes": pmesh.sharded_bytes(pipe.model_params),
           "blocks": {s: len(pipe.model_params[s]) for s in ("double_blocks", "single_blocks")},
           "pp_runner": pipe._pp_runner is not None,
           "host": all(b.device.type == "cpu" for b in pipe.model_params.buffers())}
    for i, gen in enumerate(job["generates"]):
        pmesh.reset_collectives()
        jpeg = pipe.generate(prompt="a cat", **{"silent": True, **gen})
        out[f"collectives{i}"] = dict(pmesh.COLLECTIVES)
        out[f"latents{i}"] = pipe.last_latents.float().numpy()
        out[f"jpeg{i}"] = None if jpeg is None else jpeg.getvalue()
    if job.get("save"):
        pipe.save_prequantized(job["save"])
    return out


def global_tensors(model, cfg, mesh, tensors=None) -> dict:
    """{name at global block indices: numpy} of this rank's tensors (every buffer, or
    ``tensors``), each whole (``parallel/train.py:whole_tensors``). Every rank must
    call it."""
    from flux_fp8_api_tpu_torch.parallel.train import whole_tensors

    # copies: a whole tensor may share the rank's storage
    return {k: np_(w).copy() for k, w in whole_tensors(model, cfg, tensors).items()}


def _local_batch(job):
    import torch

    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in job["batch"].items()}


def scenario_pp(mesh, job):
    """The GPipe runner on this rank's stage: the forward (gathered over dp), its
    collectives and the stage's block counts; with ``grads`` the loss and every
    trainable tensor's gradient from JAX's draws; with ``step`` one pp train step (SGD,
    or ``"adamw"``) and the updated tensors."""
    import torch

    from flux_fp8_api_tpu_torch.models.flux import flux_apply
    from flux_fp8_api_tpu_torch.parallel import mesh as pmesh
    from flux_fp8_api_tpu_torch.parallel.pp import make_pp_runner, make_pp_train_step
    from flux_fp8_api_tpu_torch.parallel.train import (
        adamw, dp_loss_and_grads, flow_matching_loss, trainable_tensors, train_cfg,
    )

    model, cfg = flux_model(job)
    model, cfg = pmesh.setup_flux(model, cfg, mesh)
    dp_axis = "dp" if "dp" in mesh.shape else None
    out = {"blocks": {s: len(model[s]) for s in ("double_blocks", "single_blocks")}}
    if "inputs" in job:
        runner = make_pp_runner(mesh, job["M"], dp_axis=dp_axis)
        xs, rows = _rows(mesh, flux_inputs(job))
        with torch.inference_mode():
            pmesh.reset_collectives()
            pred = flux_apply(model, cfg, *xs, stack_runner=runner)
            out["collectives"] = dict(pmesh.COLLECTIVES)
            out["pred"] = (pred if rows is None else mesh.all_gather(pred, "dp", 0)).float().numpy()
    if job.get("grads"):
        runner = make_pp_runner(mesh, job["M"], dp_axis=dp_axis, remat=job.get("remat", False))
        tcfg = train_cfg(cfg, remat=False)
        tensors = trainable_tensors(model)
        t, noise = torch.from_numpy(job["t"]), torch.from_numpy(job["noise"])

        def loss_fn(local, t_l, noise_l):
            return flow_matching_loss(model, tcfg, local, None, "uniform", t_l, noise_l, stack_runner=runner)

        loss, grads = dp_loss_and_grads(loss_fn, tensors, mesh, _local_batch(job), None, "uniform", t, noise,
                                        backward=True)
        out["loss"] = float(loss)
        grads = {id(p): g for p, g in zip(tensors, grads)}
        for p in tensors:
            p.grad = None
        # the gradients under the same names: swap each tensor for its gradient
        with torch.no_grad():
            saved = [p.clone() for p in tensors]
            for p in tensors:
                p.copy_(grads[id(p)])
            out["grads"] = global_tensors(model, cfg, mesh, tensors)
            for p, v in zip(tensors, saved):
                p.copy_(v)
    if job.get("step"):
        t, noise = torch.from_numpy(job["t"]), torch.from_numpy(job["noise"])
        if job["step"] == "adamw":
            init, step = make_pp_train_step(cfg, mesh, job["M"], adamw(job.get("lr", 1e-3)), dp_axis=dp_axis)
            opt = init(model)
            model, opt, loss = step(model, opt, _local_batch(job), None, t, noise)
        else:
            step = make_pp_train_step(cfg, mesh, job["M"], dp_axis=dp_axis)
            model, loss = step(model, _local_batch(job), None, t, noise)
        out["step_loss"] = float(loss)
        out["params_after"] = global_tensors(model, cfg, mesh, trainable_tensors(model))
    return out


def plant_dist_nn_fault() -> None:
    """A training fault for the tests to see: the row-parallel reduction ``g`` as
    ``torch.distributed.nn.functional.all_reduce``, whose backward sums a gradient that
    every tp rank already holds whole (tp times the gradient)."""
    import torch.distributed.nn.functional as dnn

    from flux_fp8_api_tpu_torch.ops import quant

    def reduce(x, mesh, axis):
        return dnn.all_reduce(x, group=mesh.group(axis)) if quant._grad_on(x) else mesh.all_reduce_sum(x, axis)

    quant.tp_reduce = reduce


def whole_values(model, cfg, mesh, tensors, values) -> dict:
    """:func:`global_tensors` of ``values`` (gradients, moments) laid out as
    ``tensors``: each tensor holds its value while it is read."""
    import torch

    with torch.no_grad():
        saved = [p.clone() for p in tensors]
        for p, v in zip(tensors, values):
            p.copy_(v)
        out = global_tensors(model, cfg, mesh, tensors)
        for p, v in zip(tensors, saved):
            p.copy_(v)
    return out


def scenario_mesh_train(mesh, job):
    """One sharded train step on this rank (``kind`` "sgd", "adamw" or "lora") from
    JAX's draws, the tree set up by ``setup_flux``: the loss, the gradients (sgd), the
    updated tensors whole and the moments (adamw, clipped to ``clip`` when given);
    ``steps`` AdamW steps' losses; with
    ``plant`` "dist_nn" :func:`plant_dist_nn_fault`; with ``save`` the state written
    after the step, then written again without overwrite (the error each rank raised,
    and whether the world still gathers after it); with ``restore`` a state read into fresh templates once it is
    there (its tensors and moments whole, and the loss of a step from it)."""
    import dataclasses
    import time

    import torch

    from flux_fp8_api_tpu_torch.parallel import mesh as pmesh
    from flux_fp8_api_tpu_torch.parallel import train as ptrain

    if job.get("plant") == "dist_nn":
        plant_dist_nn_fault()

    def fresh():
        m, c = flux_model(job)
        m, c = pmesh.setup_flux(m, c, mesh)
        return m, dataclasses.replace(c, use_pallas=False)

    model, cfg = fresh()
    t, noise = torch.from_numpy(job["t"]), torch.from_numpy(job["noise"])
    batch = _local_batch(job)
    kind, remat, lr = job["kind"], job.get("remat", True), job["lr"]
    out = {}
    if kind == "restore":
        while not (Path(job["restore"]) / ptrain.STATE_FILE).exists():  # written by another world
            time.sleep(0.1)
        init, step = ptrain.make_optimizer_train_step(cfg, ptrain.adamw(lr))
        opt = init(model)
        model, opt, out["restored_step"] = ptrain.restore_train_state(job["restore"], model, opt, cfg=cfg)
        tensors = ptrain.trainable_tensors(model)
        out["params"] = global_tensors(model, cfg, mesh, tensors)
        out["mu"] = whole_values(model, cfg, mesh, tensors, [opt.state[p]["mu"] for p in tensors])
        out["loss"] = float(step(model, opt, batch, None, t, noise)[2])
        return out
    if kind == "lora":
        adapters = adapters_from(job["adapters"], cfg)
        init, step = ptrain.make_lora_train_step(cfg, lambda ps: torch.optim.SGD(ps, lr=lr), remat=remat)
        opt = init(adapters)
        adapters, opt, loss = step(adapters, opt, model, batch, None, t, noise)
        out["loss"] = float(loss)
        out["adapters"] = {k: np_(w).copy() for k, w in ptrain.whole_tensors(adapters, cfg).items()}
        return out
    tensors = ptrain.trainable_tensors(model)
    if kind == "sgd":
        loss, grads = ptrain._mesh_step(ptrain.train_cfg(cfg, remat))(model, tensors, batch, None, t, noise)
        out["grads"] = whole_values(model, cfg, mesh, tensors, grads)
        model, loss = ptrain.make_train_step(cfg, remat=remat, lr=lr)(model, batch, None, t, noise)
        out["loss"] = float(loss)
        out["params"] = global_tensors(model, cfg, mesh, tensors)
        return out
    init, step = ptrain.make_optimizer_train_step(cfg, ptrain.adamw(lr), remat=remat, max_grad_norm=job.get("clip"))
    opt = init(model)
    losses = []
    for _ in range(job.get("steps", 1)):
        model, opt, loss = step(model, opt, batch, None, t, noise)
        losses.append(float(loss))
    out["losses"] = losses
    out["params"] = global_tensors(model, cfg, mesh, tensors)
    out["mu"] = whole_values(model, cfg, mesh, tensors, [opt.state[p]["mu"] for p in tensors])
    qkv = model["double_blocks"][0]["img_attn_qkv"].weight
    out["qkv_shapes"] = (tuple(qkv.shape), tuple(opt.state[qkv]["mu"].shape))
    if job.get("save"):
        ptrain.save_train_state(job["save"], model, opt, step=7, cfg=cfg)
        try:  # once more without overwrite: the first rank finds the file, every rank raises
            ptrain.save_train_state(job["save"], model, opt, step=8, cfg=cfg)
            out["resave"] = None
        except Exception as exc:
            out["resave"] = type(exc).__name__
        again = global_tensors(model, cfg, mesh, tensors)
        out["after_resave"] = all(np.array_equal(again[k], v) for k, v in out["params"].items())
    return out


def adapters_from(flat: dict, cfg):
    """Adapters from {"stack.i.leaf.a|b": numpy} in the flat layout, in ``cfg``'s."""
    import torch

    from flux_fp8_api_tpu_torch.parallel.train import local_adapters

    return local_adapters({k: torch.from_numpy(np.array(v, order="C")) for k, v in flat.items()}, cfg)


def scenario_vae(mesh, job):
    """The VAE on the mesh through FluxPipeline: the band axes it picks for some
    heights; the decode of fixed packed latents of an image of ``hw`` pixels (uint8
    pixels and the fp32 output) and the encode of a fixed image (sampled from a seeded
    generator, and the mean), each in the bands the pipeline picks; with ``img2img``
    the pipeline's own noise + encode leg at strength 0.5."""
    import torch

    from flux_fp8_api_tpu_torch.models.autoencoder import ae_decode, ae_encode
    from flux_fp8_api_tpu_torch.ops.packing import unpack_latents
    from flux_fp8_api_tpu_torch.pipeline import FluxPipeline
    from flux_fp8_api_tpu_torch.utils.config import ModelSpec
    from flux_fp8_api_tpu_torch.utils.convert import convert

    spec = ModelSpec(**job["spec"])
    pipe = FluxPipeline("flux-dev", ae=convert(job["ae"]), config=spec, mesh=mesh)
    out = {"axes": {h: pipe.ae_band_axes(h) for h in job.get("heights", ())}}
    lat = torch.from_numpy(job["latents"])
    h, w = job["hw"]
    out["pixels"] = pipe.vae_decode(lat, h, w)
    with torch.inference_mode():
        x = unpack_latents(lat.float(), h, w).permute(0, 2, 3, 1)
        band = pipe._bands(x.shape[1])
        out["decode_axes"] = None if band is None else band.axes
        y = ae_decode(pipe.ae_params, spec.ae_params, band.rows(x, 1), band)
        out["decoded"] = band.gather(y, 1).numpy()
        img = torch.from_numpy(job["image"])
        band = pipe._bands(img.shape[1], 2 ** (len(spec.ae_params.ch_mult) - 1))
        out["encode_axes"] = band.axes
        gen = torch.Generator().manual_seed(job["seed"])
        out["encoded"] = ae_encode(pipe.ae_params, spec.ae_params, band.rows(img, 1), gen, band).numpy()
        out["encoded_mean"] = ae_encode(pipe.ae_params, spec.ae_params, band.rows(img, 1), None, band).numpy()
        if job.get("img2img") is not None:  # the pipeline's own img2img leg: noise, then the banded encode
            gen = torch.Generator().manual_seed(job["seed"])
            x, _ = pipe.preprocess_latent(job["img2img"], h, w, 4, 0.5, gen, 1)
            out["img2img"] = x.float().numpy()
    return out


def scenario_autotune(mesh, job):
    """The warm-up's tile autotuning at this rank's local shape with the measure stubbed
    so that each rank would pick another tile (rank r prefers tile r + 1 of TILES): the
    tile it returns, its tuned tables and the measurements it made."""
    from flux_fp8_api_tpu_torch.ops import attention as attn
    from flux_fp8_api_tpu_torch.parallel.mesh import autotune_mesh_blocks

    tiles = [tuple(t[:2]) for t in attn.TILES]
    favourite = tiles[(mesh.global_rank + 1) % len(tiles)]
    calls = []

    def measure(l, cand, folded_heads, head_dim, iters, lkv=None):
        calls.append((l, lkv, folded_heads, tuple(cand)))
        return 1e-4 if tuple(cand) == favourite else 2e-4 + 1e-5 * tiles.index(tuple(cand))

    attn._safe_benchmark = measure
    blocks = autotune_mesh_blocks(mesh, job["joint"], job["num_heads"], job["head_dim"], seq_axis="sp")
    return {"blocks": blocks, "rect": dict(attn._TUNED_BLOCKS_RECT), "margins": dict(attn._TUNED_MARGINS_RECT),
            "calls": calls, "favourite": favourite}


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_flux, scenario_dynamic, scenario_lora, scenario_encoders, scenario_pipeline, scenario_pp,
    scenario_mesh_train, scenario_vae, scenario_autotune)}


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
