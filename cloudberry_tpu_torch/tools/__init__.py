"""Operator tools over the port: the process-kill torture harness
(``crash_torture``) and the flight-bundle replay (``flight_replay``).
Run each as ``python -m cloudberry_tpu_torch.tools.<name> --help``."""
