"""Attention (``ops/attention.py`` → K1, the program's ``qknorm_attention`` op): the
least time of the traced requests' attention (the family's ``attention_ms`` at each
request's own length, once per evaluation) over the profiled time of the kernels
``kernels/attention_k1.json`` names, in percent."""

from portbench.trace import in_family, kernel_family


def read(run):
    if run.trace is None:
        return None
    fam = kernel_family("attention_k1")
    seconds, _ = run.trace.kernel_seconds(lambda name: in_family(name, fam))
    least_ms = sum(run.evaluations(r) * run.family.attention_ms(run.spec, r.body) for r in run.timed(run.profiled))
    if seconds <= 0 or not least_ms:
        return None
    return 100.0 * least_ms / 1e3 / seconds
