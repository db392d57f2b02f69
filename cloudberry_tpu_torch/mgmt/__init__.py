"""Cluster management (mgmt/cli.py, ``python -m cloudberry_tpu_torch``)."""
