"""Model families: one module per family, ``families/<family>.py``, which a
configuration file names under ``family`` and ``run.load_family`` imports by that
name. A family holds everything the harness does that depends on the model, so a
configuration of a new family lands as new files: its family module, its plain
reference (under ``portbench/reference/``), its configuration, its mix and its
limits. A family module provides

- ``weights(spec, seed, device)``: the models' weights drawn from the seed (lazy
  :class:`portbench.weights.Weights`), by model;
- ``build(spec, weights, overrides, mark)``: the program's pipeline over them as the
  configuration ships it (``spec["spec"]`` with ``overrides``), calling
  ``mark(phase)`` as each phase of its set-up ends;
- ``steps(spec, body)``: the schedule steps a request runs;
- ``check_body(body)``: raises, naming the field, where the reference does not model
  a field of a request body (the harness asks it of the mix's bodies before set-up);
- ``keep(pipeline, body)``: what a reply keeps for the check, read as it arrives;
- ``judge(spec, seed, records, device)``: the named numbers of the check for the
  sampled records (``Record.kept`` holds ``check``, what ``keep`` kept, and
  ``timings``, the pipeline's), each with a limit of the same name in
  ``limits/<cell>.json``;
- ``CONTROLS``, ``control(spec, seed, bodies, device, name)``: the numbers of each
  control (``control.py``), the first the one the limits' upper readings come from;
- ``PUBLISHED`` (a configuration's ``source`` → the widths its checkpoint fixes) and
  ``widths(spec)`` (the same keys read from a configuration file);
- where its cells report the flow's per-layer metrics, ``evaluation_ms``,
  ``fp8_linears_ms`` and ``attention_ms`` (spec, body): the least times of one flow
  evaluation of a request, of its fp8 linears and of its attention, which the readers
  divide by.
"""
