"""Training (``train.py``) and serving over a (dp, tp, sp) mesh of ranks (``mesh.py``,
``launch.py``); pipeline parallelism (JAX ``parallel/pp.py``) waits for ROADMAP §1
item 12."""
