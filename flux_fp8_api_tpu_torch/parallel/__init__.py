"""Training (``train.py``) and serving over a (dp, tp, sp, pp) mesh of ranks
(``mesh.py``, ``launch.py``), with pipeline parallelism over the depth of the block
stacks (``pp.py``)."""
