"""The role entry scripts of the port's example jobs (``examples/``).

Each script runs as a process of its role, under
``python -m persia_tpu_torch.launcher`` or on its own, and reads the
schema YAML of the JAX package's examples (``examples/*/config/``) as
data. ``adult_income``: a DNN over a synthetic adult-income task;
``criteo``: DLRM (or another tower of the zoo) over Criteo-shaped
synthetic batches.
"""
