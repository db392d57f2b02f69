"""The serving front end: a socket server (the postmaster/tcop analog)
and its client (the libpq analog) over newline-delimited JSON."""

from cloudberry_tpu_torch.serve.client import Client, ServerError  # noqa: F401
from cloudberry_tpu_torch.serve.server import Server  # noqa: F401
