"""CLI server launcher (JAX counterpart: ``flux_fp8_api_tpu.main``; reference
``main.py:1-199``): the same flags and defaults. It serves the FastAPI app
(``api.app``) under uvicorn where both import, else the stdlib server, with the same
endpoints.

    python -m flux_fp8_api_tpu_torch.main --config-path configs/config-dev.json
    python -m flux_fp8_api_tpu_torch.main --config-path configs/config-dev-tp4.json
    python -m flux_fp8_api_tpu_torch.main --config-path configs/config-dev.json --mesh tp=2,sp=2
    python -m flux_fp8_api_tpu_torch.main --config-path configs/config-dev-prequant.json -f FILE --mesh dp=2,pp=2
    torchrun --nproc-per-node 4 -m flux_fp8_api_tpu_torch.main --config-path configs/config-dev-tp4.json

A config with a ``mesh`` (or ``--mesh``) serves over that many ranks, one process each
(``parallel/launch.py``): spawned here, or torchrun's when it started this process.
The first rank serves HTTP on ``--port``; the others follow it. ``--dist-backend``
names the process group's backend: nccl (the default) takes one rank per card, gloo
lets ranks share a card or run on the host.
"""

from __future__ import annotations

import argparse
import logging
import math

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Launch the Flux fp8 API server (PyTorch/CUDA)")
    parser.add_argument("-c", "--config-path", type=str,
                        help="Path to a config JSON; if absent the model is built from the flags below")
    parser.add_argument("-p", "--port", type=int, default=8088, help="Port to run the server on")
    parser.add_argument("-H", "--host", type=str, default="0.0.0.0", help="Host to run the server on")
    parser.add_argument("-f", "--flow-model-path", type=str, help="Path to the flow model safetensors")
    parser.add_argument("-t", "--text-enc-path", type=str, help="Path to the T5 encoder directory")
    parser.add_argument("-a", "--autoencoder-path", type=str, help="Path to the autoencoder safetensors")
    parser.add_argument("-m", "--model-version", type=str,
                        choices=["flux-dev", "flux-schnell", "flux-dev-kontext"], default="flux-dev")
    parser.add_argument("-F", "--flux-device", type=str, default="tpu:0",
                        help="Device for the flow model (tpu:N, gpu:N and cuda:N all select CUDA device N)")
    parser.add_argument("-T", "--text-enc-device", type=str, default="tpu:0")
    parser.add_argument("-A", "--autoencoder-device", type=str, default="tpu:0")
    parser.add_argument("-q", "--num-to-quant", type=int, default=20,
                        help="(deprecated, kept for reference-CLI parity)")
    parser.add_argument("-C", "--compile", action="store_true",
                        help="Serve the blocks and extras torch.compile'd (compile_blocks/compile_extras); "
                             "calibrate, compile and warm up the serving bucket before serving")
    parser.add_argument("-qT", "--quant-text-enc", type=str, default="qfloat8",
                        choices=["qint4", "qfloat8", "qint2", "qint8", "bf16"],
                        dest="quant_text_enc",
                        help="Quantization tier for the T5 text encoder")
    parser.add_argument("-qA", "--quant-ae", action="store_true", dest="quant_ae",
                        help="Quantize the autoencoder with weight-only fp8")
    # offload semantics match the reference (main.py:97-120): flow offload is opt-in,
    # ae/text-enc offload default on and -OA/-OT disable them
    parser.add_argument("-OF", "--offload-flow", action="store_true", default=False,
                        dest="offload_flow",
                        help="Offload the flow model to the host when not in use")
    parser.add_argument("-OA", "--no-offload-ae", action="store_false", default=True,
                        dest="offload_ae",
                        help="Disable offloading the autoencoder to the host when not in use")
    parser.add_argument("-OT", "--no-offload-text-enc", action="store_false", default=True,
                        dest="offload_text_enc",
                        help="Disable offloading the text encoder to the host when not in use")
    parser.add_argument("-PF", "--prequantized-flow", action="store_true",
                        help="Flow checkpoint already carries fp8 data + scales (skips calibration)")
    parser.add_argument("-nqfm", "--no-quantize-flow-modulation", dest="quantize_modulation",
                        action="store_false", default=True,
                        help="Keep modulation linears unquantized")
    parser.add_argument("-qfl", "--quantize-flow-embedder-layers", action="store_true",
                        help="Also quantize img_in/txt_in/time_in/vector_in/guidance_in")
    parser.add_argument("--compilation-cache-dir", type=str, default=None,
                        help="Directory for the attention tiles that warm-up measures (attn_blocks.json): "
                             "loaded before the warm-up and saved after it, so a restart measures nothing "
                             "again (PyTorch runs eagerly, so there is nothing else to cache there)")
    parser.add_argument("--save-prequantized", type=str, default=None, metavar="PATH",
                        help="Calibrate (if needed), save a prequantized flow checkpoint "
                             "(quantized data + weight/input scales) to PATH, then exit "
                             "instead of serving; reload it with -PF")
    parser.add_argument("--mesh", type=str, default=None,
                        help="Multi-GPU serving mesh, e.g. 'dp=1,tp=4', 'tp=2,sp=2' or 'dp=2,pp=2': "
                             "shards the flow over (data, tensor, sequence, pipeline) parallel axes, "
                             "one rank per process (overrides the config file's mesh field)")
    parser.add_argument("--dist-backend", type=str, default="nccl", choices=["nccl", "gloo"],
                        help="torch.distributed backend of a mesh: nccl (one rank per card) or "
                             "gloo (ranks may share a card, or run on the host)")
    return parser.parse_args(argv)


def parse_mesh(spec: str):
    """'dp=1,tp=4' → {"dp": 1, "tp": 4} (preserving axis order; JAX main.py:69-80)."""
    mesh = {}
    for part in spec.split(","):
        axis, _, size = part.partition("=")
        if not axis or not size:
            raise SystemExit(f"--mesh {spec!r}: expected comma-separated axis=size pairs")
        try:
            mesh[axis.strip()] = int(size)
        except ValueError:
            raise SystemExit(f"--mesh {spec!r}: size for axis {axis!r} is not an integer")
    return mesh


def _overrides(args) -> dict:
    """The ModelSpec fields the server sets over a config (JAX main.py:88-96): the
    servers only generate silently, so compile() skips the interactive warm-up; and
    ``--compilation-cache-dir`` where given."""
    overrides = {"precompile_interactive": False}
    if args.compilation_cache_dir:
        overrides["compilation_cache_dir"] = args.compilation_cache_dir
    return overrides


def _config(args):
    """The ModelSpec of the command line: the config file (with ``-f``), or the flags,
    with :func:`_overrides`."""
    from .utils.config import ModelVersion, load_config, load_config_from_path

    if args.config_path:
        config = load_config_from_path(args.config_path)
        if args.flow_model_path:
            config.ckpt_path = args.flow_model_path
    else:
        config = load_config(
            ModelVersion(args.model_version),
            flux_path=args.flow_model_path,
            flux_device=args.flux_device,
            ae_path=args.autoencoder_path,
            ae_device=args.autoencoder_device,
            text_enc_path=args.text_enc_path,
            text_enc_device=args.text_enc_device,
            num_to_quant=args.num_to_quant,
            compile_extras=args.compile,
            compile_blocks=args.compile,
            quant_text_enc=(None if args.quant_text_enc == "bf16" else args.quant_text_enc),
            quant_ae=args.quant_ae,
            offload_flow=args.offload_flow,
            offload_ae=args.offload_ae,
            offload_text_enc=args.offload_text_enc,
            prequantized_flow=args.prequantized_flow,
            quantize_modulation=args.quantize_modulation,
            quantize_flow_embedder_layers=args.quantize_flow_embedder_layers,
        )
    if args.mesh:
        config.mesh = parse_mesh(args.mesh)
    for key, value in _overrides(args).items():
        setattr(config, key, value)
    return config


def _logging() -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(levelname)-7s | %(name)s - %(message)s")


def main(argv=None):
    args = parse_args(argv)
    _logging()
    config = _config(args)
    if config.mesh:
        from .parallel.launch import run_ranks
        from .parallel.mesh import parse_axes

        run_ranks(_serve_rank, math.prod(parse_axes(config.mesh).values()), (args, config))
        return
    from .pipeline import FluxPipeline

    if args.config_path:
        pipeline = FluxPipeline.load_pipeline_from_config_path(args.config_path, flow_model_path=args.flow_model_path,
                                                               **_overrides(args))
    else:
        pipeline = FluxPipeline.load_pipeline_from_config(config)
    _serve(args, pipeline)


def _serve_rank(args, config) -> None:
    """One rank of a mesh: its pipeline, then the server (first rank) or the follower
    loop. A rank runs on ``cuda:{LOCAL_RANK % cards}``, or on the host when the config
    puts the flow there."""
    _logging()
    from .parallel.launch import MeshPipeline, follower_loop
    from .parallel.mesh import make_mesh
    from .pipeline import FluxPipeline

    on_host = str(config.flux_device or "").startswith("cpu")
    mesh = make_mesh(config.mesh, backend=args.dist_backend, device="cpu" if on_host else None)
    pipeline = FluxPipeline.load_pipeline_from_config(config, mesh=mesh)
    if args.save_prequantized or not mesh.is_root:
        if args.save_prequantized:  # every rank calibrates and gathers; the first writes
            _save_prequantized(args, pipeline)
        else:
            follower_loop(pipeline)
        return
    front = MeshPipeline(pipeline)
    try:
        _serve(args, front)
    finally:
        front.stop()


def _save_prequantized(args, pipeline) -> None:
    if pipeline._needs_calibration:
        # the reference's warmup recipe until the input scales freeze: the file ships them
        logger.info("calibrating input scales before the prequantized export …")
        pipeline.compile()
    pipeline.save_prequantized(args.save_prequantized)
    logger.info("prequantized flow checkpoint written to %s — serve it with "
                "--config-path configs/config-dev-prequant.json -f %s (ckpt_path, "
                "prequantized_flow=true)", args.save_prequantized, args.save_prequantized)


def _serve(args, pipeline) -> None:
    if args.save_prequantized:
        _save_prequantized(args, pipeline)
        return
    try:
        import uvicorn

        from .api import app
    except ImportError:  # no fastapi or uvicorn: the stdlib server, same endpoints
        from .server import serve

        serve(pipeline, host=args.host, port=args.port)
    else:
        app.state.model = pipeline
        uvicorn.run(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
