"""The port's management CLI (mgmt/cli.py, ``python -m
cloudberry_tpu_torch``) against the JAX package's, driven in process
through ``main(argv)`` with ``--device cpu``; the commands not ported yet
(fsck, fdist, mcp, expand --online) raise. Mirrors tests/test_cli.py."""

import json
import os
import queue
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from cloudberry_tpu.mgmt import cli as JC
from cloudberry_tpu_torch.mgmt import cli as TC

ROOT = Path(__file__).resolve().parent.parent


def _both(capsys, tmp_path, *argv):
    """Run one command line in both engines over their own stores:
    (jax rc, jax output, port rc, port output)."""
    outs = []
    for main, name, dev in ((JC.main, "jax", []),
                            (TC.main, "port", ["--device", "cpu"])):
        rc = main([*dev, "--store", str(tmp_path / name), *argv])
        outs += [rc, capsys.readouterr().out]
    return outs


def test_init_sql_state_roundtrip(tmp_path, capsys):
    assert _both(capsys, tmp_path, "init", "--segments", "4")[::2] == [0, 0]
    assert _both(capsys, tmp_path, "init", "--segments", "2")[::2] == [1, 1]
    for q in ("create table kv (k bigint, v decimal(10,2)) "
              "distributed by (k)",
              "insert into kv values (1, 1.5), (2, 2.5), (3, 3.5)"):
        jr, jo, tr, to = _both(capsys, tmp_path, "sql", "--save", q)
        assert (jr, tr) == (0, 0) and jo == to
    jr, jo, tr, to = _both(capsys, tmp_path, "sql",
                           "select sum(v) as s, count(*) as n from kv")
    assert (jr, tr) == (0, 0) and jo == to and "7.5" in to
    jr, jo, tr, to = _both(capsys, tmp_path, "state")
    assert (jr, tr) == (0, 0)
    for line in ("segments:        4", "health probe:    OK",
                 "table kv: v3, 1 partitions, 3 rows"):
        assert line in jo and line in to
    assert "devices visible: 1 (cpu)" in to


def test_probe_and_expand(tmp_path, capsys):
    jr, jo, tr, to = _both(capsys, tmp_path, "probe")
    assert (jr, tr) == (0, 0)
    assert json.loads(to)["ok"] and json.loads(to)["devices"] >= 1
    _both(capsys, tmp_path, "init", "--segments", "4")
    _both(capsys, tmp_path, "sql", "--save",
          "create table m (k bigint) distributed by (k)")
    rows = ",".join(f"({i})" for i in range(2000))
    _both(capsys, tmp_path, "sql", "--save", f"insert into m values {rows}")
    jr, jo, tr, to = _both(capsys, tmp_path, "expand", "--segments", "5")
    assert (jr, tr) == (0, 0) and jo == to and "4 → 5" in to
    assert float(to.split("m: ")[1].split("%")[0]) < 30.0
    assert TC.load_cluster(str(tmp_path / "port"))["n_segments"] == 5
    jr, jo, tr, to = _both(capsys, tmp_path, "sql",
                           "select count(*) as n from m")
    assert jo == to and "2000" in to


def test_check_detects_corruption(tmp_path, capsys):
    _both(capsys, tmp_path, "init", "--segments", "2")
    _both(capsys, tmp_path, "sql", "--save",
          "create table c (x bigint, s text)")
    _both(capsys, tmp_path, "sql", "--save",
          "insert into c values (1, 'aa'), (2, 'bb')")
    jr, jo, tr, to = _both(capsys, tmp_path, "check")
    assert (jr, tr) == (0, 0) and jo == to
    for name in ("jax", "port"):
        tdir = tmp_path / name / "c"
        part = [f for f in os.listdir(tdir) if f.endswith(".cbmp")][0]
        with open(tdir / part, "r+b") as fh:
            fh.write(b"GARBAGE!")
    jr, jo, tr, to = _both(capsys, tmp_path, "check")
    assert (jr, tr) == (1, 1) and "CORRUPT" in to


@pytest.mark.parametrize("argv", [["fsck"], ["fdist"], ["mcp"],
                                  ["expand", "--segments", "3",
                                   "--online"]],
                         ids=["fsck", "fdist", "mcp", "expand-online"])
def test_unported_commands_raise(tmp_path, argv):
    store = str(tmp_path / "port")
    TC.main(["--device", "cpu", "--store", store, "init"])
    with pytest.raises(NotImplementedError, match="Queue A 9b"):
        TC.main(["--device", "cpu", "--store", store, *argv])


def test_serve_subprocess_and_sql_connect(tmp_path, capsys):
    """``python -m cloudberry_tpu_torch --device cpu --store DIR serve``
    in a child process, queried by ``sql --connect``; the server drains
    and exits on SIGINT."""
    import signal
    import socket

    store = str(tmp_path / "port")
    TC.main(["--device", "cpu", "--store", store, "init"])
    TC.main(["--device", "cpu", "--store", store, "sql", "--save",
             "create table s (x bigint, y text)"])
    TC.main(["--device", "cpu", "--store", store, "sql", "--save",
             "insert into s values (1, 'a'), (2, null)"])
    capsys.readouterr()
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "cloudberry_tpu_torch", "--device", "cpu",
         "--store", store, "serve", "--port", str(port)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "PYTHONPATH": str(ROOT)})
    lines = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(x) for x in proc.stdout], daemon=True)
    reader.start()
    try:
        line = lines.get(timeout=120)
        assert f"serving on 127.0.0.1:{port}" in line, line
        assert "cpu" in line
        deadline = time.monotonic() + 60
        while True:
            try:
                rc = TC.main(["sql", "--connect", f"127.0.0.1:{port}",
                              "select x, y from s order by x"])
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        assert rc == 0
        assert capsys.readouterr().out == "x\ty\n1\ta\n2\tNone\n"
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        reader.join(timeout=10)
    assert proc.returncode == 0
