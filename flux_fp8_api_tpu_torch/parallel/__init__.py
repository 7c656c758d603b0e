"""Training (``train.py``); the device meshes and pipeline parallelism of the JAX
package's ``parallel/`` wait for multi-GPU (ROADMAP §1 item 12)."""
