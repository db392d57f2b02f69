"""The port's management CLI (mgmt/cli.py, ``python -m
cloudberry_tpu_torch``) against the JAX package's, driven in process
through ``main(argv)`` with ``--device cpu``; the commands that once
raised in the port (fsck, fdist, mcp, expand --online) run and answer as
the JAX package's do. Mirrors tests/test_cli.py."""

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
def test_unported_commands_raise(tmp_path, capsys, monkeypatch, argv):
    """The four commands that raised ``NotImplementedError`` (ROADMAP
    Queue A 9b) until they were ported now run in the port, with the JAX
    package's output on the same request: fsck's report, the MCP stdio
    server's answers, the online expand's printout (its cutover time
    aside), and cbfdist's bytes from a ``python -m cloudberry_tpu_torch
    fdist`` child."""
    import io
    import re
    import urllib.request

    _both(capsys, tmp_path, "init", "--segments", "2")
    _both(capsys, tmp_path, "sql", "--save",
          "create table m (k bigint, v bigint) distributed by (k)")
    _both(capsys, tmp_path, "sql", "--save",
          "insert into m values " + ",".join(
              f"({i}, {i % 7})" for i in range(300)))
    if argv[0] == "fdist":
        (tmp_path / "f.csv").write_text("".join(
            f"{i}|x\n" for i in range(10)))
        with __import__("socket").socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        proc = subprocess.Popen(
            [sys.executable, "-m", "cloudberry_tpu_torch", "fdist",
             "--root", str(tmp_path), "--port", str(port), "--host",
             "127.0.0.1"], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "PYTHONPATH": str(ROOT)})
        try:
            lines = queue.Queue()
            threading.Thread(target=lambda: [lines.put(x)
                                             for x in proc.stdout],
                             daemon=True).start()
            assert "cbfdist serving" in lines.get(timeout=120)
            url = f"http://127.0.0.1:{port}/f.csv?segment=1&nseg=3"
            with urllib.request.urlopen(url, timeout=30) as r:
                assert r.read() == b"1|x\n4|x\n7|x\n"
        finally:
            proc.kill()
            proc.wait(timeout=30)
        return
    if argv[0] == "mcp":
        reqs = [{"jsonrpc": "2.0", "id": 1, "method": "initialize"},
                {"jsonrpc": "2.0", "id": 2, "method": "tools/call",
                 "params": {"name": "execute_query", "arguments": {
                     "sql": "select v, count(*) as n from m group by v "
                            "order by v"}}},
                {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
                 "params": {"name": "execute_query",
                            "arguments": {"sql": "delete from m"}}}]
        text = "".join(json.dumps(r) + "\n" for r in reqs)
        outs = []
        for main, name, dev in ((JC.main, "jax", []),
                                (TC.main, "port", ["--device", "cpu"])):
            monkeypatch.setattr(sys, "stdin", io.StringIO(text))
            assert main([*dev, "--store", str(tmp_path / name),
                         *argv]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[1] == outs[0]
        resp = [json.loads(x) for x in outs[1].splitlines()]
        assert json.loads(resp[1]["result"]["content"][0]["text"])[
            "rowcount"] == 7
        assert resp[2]["error"]["code"] == -32602
        return
    jr, jo, tr, to = _both(capsys, tmp_path, *argv)
    assert (jr, tr) == (0, 0)
    strip = re.compile(r"cutover [0-9.]+ ms")
    assert strip.sub("", to) == strip.sub("", jo)
    if argv[0] == "expand":
        assert "2 → 3 segments ONLINE" in to and "minimal-movement" in to
        assert TC.load_cluster(str(tmp_path / "port"))["n_segments"] == 3
    else:
        assert "fsck clean" in to


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
