"""The quantized linears (``ops/quant.py`` → ``torch._scaled_mm``): the least time of
the traced requests' fp8 linears (the family's ``fp8_linears_ms`` per evaluation, at
each request's own length) over the profiled time of the kernels
``kernels/gemm_fp8.json`` names, in percent."""

from portbench.trace import in_family, kernel_family


def read(run):
    if run.trace is None:
        return None
    fam = kernel_family("gemm_fp8")
    seconds, _ = run.trace.kernel_seconds(lambda name: in_family(name, fam))
    least_ms = sum(run.evaluations(r) * run.family.fp8_linears_ms(run.spec, r.body)
                   for r in run.timed(run.profiled))
    if seconds <= 0 or not least_ms:
        return None
    return 100.0 * least_ms / 1e3 / seconds
