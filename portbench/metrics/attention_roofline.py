"""Attention (``ops/attention.py`` → K1, ``flux_fp8::qknorm_attention``): the least
time of the traced requests' attention (``flops.attention_bound`` at each request's
joint length, once per block of each evaluation) over the profiled time of the kernels
``kernels/attention_k1.json`` names, in percent."""

from portbench import flops
from portbench.trace import in_family, kernel_family


def read(run):
    if run.trace is None:
        return None
    fam = kernel_family("attention_k1")
    seconds, _ = run.trace.kernel_seconds(lambda name: in_family(name, fam))
    p = run.params
    blocks, head_dim = p["depth"] + p["depth_single_blocks"], p["hidden_size"] // p["num_heads"]
    least_ms = sum(run.evaluations(r) * blocks * flops.attention_bound(p["num_heads"], run.lengths(r)[1], head_dim)[0]
                   for r in run.timed(run.profiled))
    if seconds <= 0 or not least_ms:
        return None
    return 100.0 * least_ms / 1e3 / seconds
