"""A cell at a size the CPU runs in seconds: ``configs/config-tiny-cpu.json``'s flow and
VAE with the shipped configurations' tiers (fp8 flow, fp8 weight-only T5, compiled
blocks and extras), a guidance-embedded flux-dev, and 2-layer T5 and CLIP towers at
the flow's widths."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[2]


def tiny_cell(version: str = "flux-dev", steps: int = 3, body: Optional[dict] = None, limits: str = "dev-1024") -> dict:
    """The tiny cell; ``body`` adds fields to every request, ``limits`` names the
    ``limits/<cell>.json`` it is judged by."""
    from portbench import run

    spec = json.loads((ROOT / "configs" / "config-tiny-cpu.json").read_text())
    spec.update(version=version, flow_quantization_dtype="qfloat8", text_enc_quantization_dtype="qfloat8",
                compile_blocks=True, compile_extras=True, num_scale_trials=4)
    spec["params"]["guidance_embed"] = version == "flux-dev"
    p = spec["params"]
    t5 = {"vocab_size": 300, "d_model": p["context_in_dim"], "d_ff": 96, "num_layers": 2, "num_heads": 4,
          "d_kv": 12, "relative_attention_num_buckets": 32, "relative_attention_max_distance": 128,
          "layer_norm_epsilon": 1e-6}
    clip = {"vocab_size": 300, "hidden_size": p["vec_in_dim"], "intermediate_size": 64, "num_layers": 2,
            "num_heads": 4, "max_position_embeddings": 77, "layer_norm_eps": 1e-5, "eos_token_id": 2}
    words = (ROOT / "portbench" / "traffic" / "prompt-words.txt").read_text().split()
    mix = {"loop": "closed", "clients": 1, "body": {"guidance": 3.5, **(body or {})},
           "shapes": [{"width": 64, "height": 64, "num_steps": steps, "weight": 1}],
           "prompt_words": [8, 60], "emphasis_share": 0.5, "words": "prompt-words.txt", "word_list": words,
           "profiled_requests": 1, "checked_requests": 2}
    return {"cell": {"name": "tiny", "chips": 1},
            "spec": {"name": "tiny", "family": "flux", "spec": spec, "t5": t5, "clip": clip},
            "family": run.load_family("flux"), "mix": mix,
            "limits": json.loads((ROOT / "portbench" / "limits" / f"{limits}.json").read_text()),
            "per_layer": [], "end_to_end": [
                {"name": n, "unit": u} for n, u in (("images_per_s", "images/s"), ("first_byte_p95_s", "s"),
                                                    ("setup_s", "s"))]}


def stdlib_serve(pipeline):
    """The program's stdlib server in place of uvicorn, for machines without uvicorn."""
    from flux_fp8_api_tpu_torch.server import PipelineServer

    from portbench.system import Served

    srv = PipelineServer(pipeline, host="127.0.0.1", port=0)
    srv.start_background()
    return Served(srv.port, srv, srv.shutdown)
