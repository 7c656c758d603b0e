"""Dependency-free browser UI, served at ``GET /`` by the stdlib server and the FastAPI
app (JAX counterpart: ``flux_fp8_api_tpu.webui``).

The reference ships a Gradio front end (``main_gr.py:1-132``). This page offers its
controls without a gradio wheel: one self-contained HTML page (inline CSS and vanilla
JS, no external assets) that drives ``POST /generate`` and ``POST /lora``:
text-to-image and image-to-image (source upload → base64 ``init_image``, noising
strength), resolution presets and custom width/height in steps of 16, steps, guidance,
seed (blank or -1 = random) with the used seed read back from ``X-Seed``, the
step-cache selector (``STEP_CACHE_PRESETS``, the JAX page's two presets, sent as the
request's ``cache``), a LoRA load/unload panel, and a /metrics readout with
``denoise_it_per_s`` and ``cache_model_evals``.
"""

from __future__ import annotations

import json

RESOLUTION_PRESETS = {
    "square 1024 (1:1)": (1024, 1024),
    "portrait 832×1216 (2:3)": (832, 1216),
    "landscape 1216×832 (3:2)": (1216, 832),
    "wide 1344×768 (16:9)": (1344, 768),
    "custom": None,
}

# label → the request's ``cache`` (None: every step evaluated); the JAX page's presets
STEP_CACHE_PRESETS = {
    "off: every step evaluated": None,
    "dynamic, threshold 0.4: skip while the block-0 input drifts little": {"mode": "dynamic", "threshold": 0.4},
    "interval 4: evaluate every 4th step": {"mode": "interval", "interval": 4},
}

_PAGE = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>flux-fp8-api-tpu-torch</title>
<style>
  :root { color-scheme: light dark; }
  body { font: 15px/1.45 system-ui, sans-serif; margin: 0 auto; max-width: 1100px;
         padding: 1.2rem; }
  h1 { font-size: 1.25rem; margin: 0 0 .2rem; }
  .sub { opacity: .65; margin-bottom: 1rem; font-size: .85rem; }
  .cols { display: flex; gap: 1.2rem; flex-wrap: wrap; }
  .panel { flex: 1 1 420px; min-width: 320px; }
  fieldset { border: 1px solid #8884; border-radius: 8px; margin: 0 0 1rem;
             padding: .8rem 1rem; }
  legend { font-weight: 600; padding: 0 .4rem; }
  label { display: block; margin: .45rem 0 .1rem; font-size: .85rem; opacity: .85; }
  textarea, input, select { width: 100%; box-sizing: border-box; padding: .4rem;
    border: 1px solid #8886; border-radius: 6px; background: transparent;
    color: inherit; font: inherit; }
  textarea { min-height: 4.2em; resize: vertical; }
  .row { display: flex; gap: .7rem; } .row > div { flex: 1; }
  button { padding: .5rem 1.1rem; border-radius: 6px; border: 1px solid #8886;
    background: #3b82f6; color: #fff; font: inherit; cursor: pointer; margin-top: .6rem; }
  button.minor { background: transparent; color: inherit; }
  button:disabled { opacity: .5; cursor: wait; }
  img#result { max-width: 100%; border-radius: 8px; margin-top: .6rem; display: none; }
  pre { background: #8881; border-radius: 6px; padding: .6rem; overflow: auto;
        font-size: .8rem; white-space: pre-wrap; }
  .status { font-size: .85rem; margin-top: .5rem; min-height: 1.2em; }
  .err { color: #dc2626; }
</style>
</head>
<body>
<h1>flux-fp8-api-tpu-torch</h1>
<div class="sub" id="modelline">loading…</div>
<div class="cols">
<div class="panel">
  <fieldset>
    <legend>Generate</legend>
    <label for="prompt">Prompt</label>
    <textarea id="prompt" placeholder="describe the image to generate…"></textarea>
    <div class="row">
      <div><label for="preset">Resolution</label>
        <select id="preset"></select></div>
      <div><label for="width">Width (custom)</label>
        <input id="width" type="number" min="128" max="4096" step="16" value="1024"></div>
      <div><label for="height">Height (custom)</label>
        <input id="height" type="number" min="128" max="4096" step="16" value="1024"></div>
    </div>
    <div class="row">
      <div><label for="steps">Steps</label>
        <input id="steps" type="number" min="1" max="50" value="28"></div>
      <div><label for="guidance">Guidance</label>
        <input id="guidance" type="number" min="1" max="10" step="0.1" value="3.5"></div>
      <div><label for="seed">Seed (blank/-1 = random)</label>
        <input id="seed" type="text" value=""></div>
    </div>
    <label for="cache">Step cache (fewer model evaluations, output further from uncached)</label>
    <select id="cache"></select>
    <label for="init">Source image (optional → image-to-image)</label>
    <input id="init" type="file" accept="image/*">
    <label for="strength">Noising strength (1 = ignore source)</label>
    <input id="strength" type="number" min="0" max="1" step="0.05" value="0.75">
    <button id="go">Generate</button>
    <button id="clear" class="minor" type="button">Clear source image</button>
    <div class="status" id="status"></div>
  </fieldset>
  <fieldset>
    <legend>LoRA</legend>
    <div class="row">
      <div><label for="lora_path">Path</label><input id="lora_path" type="text"></div>
      <div><label for="lora_name">Name</label><input id="lora_name" type="text"></div>
      <div><label for="lora_scale">Scale</label>
        <input id="lora_scale" type="number" step="0.05" value="1.0"></div>
    </div>
    <button id="lora_load" class="minor" type="button">Load</button>
    <button id="lora_unload" class="minor" type="button">Unload</button>
    <pre id="lora_out" hidden></pre>
  </fieldset>
</div>
<div class="panel">
  <fieldset>
    <legend>Result</legend>
    <img id="result" alt="generated image">
    <pre id="record" hidden></pre>
    <a id="download" hidden download="flux.jpg">Download JPEG</a>
  </fieldset>
  <fieldset>
    <legend>Metrics</legend>
    <button id="metrics_btn" class="minor" type="button">Refresh /metrics</button>
    <pre id="metrics" hidden></pre>
  </fieldset>
</div>
</div>
<script>
"use strict";
const CFG = __CONFIG__;
const $ = (id) => document.getElementById(id);
const PRESETS = CFG.presets;
for (const name of Object.keys(PRESETS)) {
  const o = document.createElement("option");
  o.value = name; o.textContent = name;
  $("preset").appendChild(o);
}
for (const name of Object.keys(CFG.cache_presets)) {
  const o = document.createElement("option");
  o.value = name; o.textContent = name;
  $("cache").appendChild(o);
}
$("steps").value = CFG.default_steps;
$("modelline").textContent =
  `${CFG.model} (${CFG.version}) on ${CFG.platform} — browser UI of the Gradio front end's controls`;
$("preset").addEventListener("change", () => {
  const wh = PRESETS[$("preset").value];
  if (wh) { $("width").value = wh[0]; $("height").value = wh[1]; }
});
// Read the source file lazily at click time (promise-wrapped FileReader): an
// eager change-listener read races Generate — clicking before onload fired
// would silently send plain txt2img with the init_image dropped.
function readInit() {
  const f = $("init").files[0];
  if (!f) return Promise.resolve(null);
  return new Promise((resolve, reject) => {
    const r = new FileReader();
    // strip the data:*;base64, prefix — the API's init_image field takes raw
    // base64 (reference api.py:47 decodes with pybase64.b64decode)
    r.onload = () => resolve(String(r.result).split(",", 2)[1]);
    r.onerror = () => reject(r.error);
    r.readAsDataURL(f);
  });
}
$("clear").addEventListener("click", () => { $("init").value = ""; });
function seedValue() {
  const t = $("seed").value.trim();
  if (t === "" || t === "-1") return null;
  const n = parseInt(t, 10);
  return Number.isFinite(n) && n >= 0 ? n : null;
}
$("go").addEventListener("click", async () => {
  const body = {
    prompt: $("prompt").value,
    width: parseInt($("width").value, 10),
    height: parseInt($("height").value, 10),
    num_steps: parseInt($("steps").value, 10),
    guidance: parseFloat($("guidance").value),
    strength: parseFloat($("strength").value),
  };
  const seed = seedValue();
  if (seed !== null) body.seed = seed;
  const cache = CFG.cache_presets[$("cache").value];
  if (cache) body.cache = cache;
  $("go").disabled = true;
  $("status").textContent = "generating…"; $("status").className = "status";
  const t0 = performance.now();
  try {
    const initB64 = await readInit();
    if (initB64) body.init_image = initB64;
    const resp = await fetch("generate", {
      method: "POST",
      headers: { "content-type": "application/json" },
      body: JSON.stringify(body),
    });
    if (!resp.ok) throw new Error(`${resp.status}: ${await resp.text()}`);
    const blob = await resp.blob();
    const url = URL.createObjectURL(blob);
    $("result").src = url; $("result").style.display = "block";
    $("download").href = url; $("download").hidden = false;
    const usedSeed = resp.headers.get("x-seed");
    const dt = ((performance.now() - t0) / 1000).toFixed(1);
    $("status").textContent = `done in ${dt}s (seed ${usedSeed ?? "?"})`;
    const rec = Object.assign({}, body, { seed: usedSeed !== null ? Number(usedSeed) : body.seed });
    if (!initB64) delete rec.strength;
    delete rec.init_image;
    $("record").textContent = JSON.stringify(rec, null, 2);
    $("record").hidden = false;
  } catch (e) {
    $("status").textContent = String(e); $("status").className = "status err";
  } finally {
    $("go").disabled = false;
  }
});
async function lora(action) {
  const body = {
    action,
    path: $("lora_path").value || null,
    name: $("lora_name").value || null,
    scale: parseFloat($("lora_scale").value),
  };
  const resp = await fetch("lora", {
    method: "POST",
    headers: { "content-type": "application/json" },
    body: JSON.stringify(body),
  });
  $("lora_out").textContent = await resp.text();
  $("lora_out").hidden = false;
}
$("lora_load").addEventListener("click", () => lora("load"));
$("lora_unload").addEventListener("click", () => lora("unload"));
$("metrics_btn").addEventListener("click", async () => {
  const resp = await fetch("metrics");
  $("metrics").textContent = JSON.stringify(await resp.json(), null, 2);
  $("metrics").hidden = false;
});
</script>
</body>
</html>
"""


def render_index(pipeline) -> bytes:
    """The page with the pipeline's identity and defaults filled in."""
    version = str(getattr(getattr(pipeline, "config", None), "version", "") or "?")
    device = getattr(pipeline, "device_flux", None)
    cfg = {
        "model": getattr(pipeline, "name", None) or "flux",
        "version": version,
        "platform": getattr(device, "type", None) or "cuda",
        "default_steps": 4 if "schnell" in version else 28,
        "presets": {k: v for k, v in RESOLUTION_PRESETS.items() if v},
        "cache_presets": STEP_CACHE_PRESETS,
    }
    return _PAGE.replace("__CONFIG__", json.dumps(cfg)).encode()
