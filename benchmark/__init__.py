"""The benchmark of the PyTorch / CUDA port (skybox_rt_tpu_torch): run one
cell with benchmark/run.py; see README.md in this folder."""
