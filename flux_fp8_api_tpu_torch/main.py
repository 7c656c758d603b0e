"""CLI server launcher (JAX counterpart: ``flux_fp8_api_tpu.main``; reference
``main.py:1-199``): the same flags and defaults. It serves the FastAPI app
(``api.app``) under uvicorn where both import, else the stdlib server, with the same
endpoints.

    python -m flux_fp8_api_tpu_torch.main --config-path configs/config-dev.json
"""

from __future__ import annotations

import argparse
import logging

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
                        choices=["flux-dev", "flux-schnell"], default="flux-dev")
    parser.add_argument("-F", "--flux-device", type=str, default="tpu:0",
                        help="Device for the flow model (tpu:N, gpu:N and cuda:N all select CUDA device N)")
    parser.add_argument("-T", "--text-enc-device", type=str, default="tpu:0")
    parser.add_argument("-A", "--autoencoder-device", type=str, default="tpu:0")
    parser.add_argument("-q", "--num-to-quant", type=int, default=20,
                        help="(deprecated, kept for reference-CLI parity)")
    parser.add_argument("-C", "--compile", action="store_true",
                        help="Calibrate and warm up the serving bucket before serving")
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
                        help="(no effect here: PyTorch runs eagerly, nothing is compiled ahead)")
    parser.add_argument("--save-prequantized", type=str, default=None, metavar="PATH",
                        help="Calibrate (if needed), save a prequantized flow checkpoint "
                             "(quantized data + weight/input scales) to PATH, then exit "
                             "instead of serving; reload it with -PF")
    parser.add_argument("--mesh", type=str, default=None,
                        help="Multi-device serving mesh (not ported yet)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(levelname)-7s | %(name)s - %(message)s")
    if args.mesh:
        raise NotImplementedError("--mesh is not ported yet (ROADMAP: multi-GPU)")

    from .pipeline import FluxPipeline
    from .utils.config import ModelVersion, load_config

    if args.config_path:
        pipeline = FluxPipeline.load_pipeline_from_config_path(
            args.config_path, flow_model_path=args.flow_model_path
        )
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
        pipeline = FluxPipeline.load_pipeline_from_config(config)

    if args.save_prequantized:
        if pipeline._needs_calibration:
            # the reference's warmup recipe until the input scales freeze: the file
            # ships them
            logger.info("calibrating input scales before the prequantized export …")
            pipeline.compile()
        pipeline.save_prequantized(args.save_prequantized)
        logger.info("prequantized flow checkpoint written to %s — serve it with "
                    "--config-path configs/config-dev-prequant.json -f %s (ckpt_path, "
                    "prequantized_flow=true)", args.save_prequantized, args.save_prequantized)
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
