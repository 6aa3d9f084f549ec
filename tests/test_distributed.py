"""Simulated multi-host run: two OS processes, 2 virtual CPU devices
each, joined through the framework's own ``init_distributed`` (Gloo
over localhost stands in for the network).  Validates that the sharded engine's
collectives (halo ppermute, exact distributed median, psum/pstd) work
across a real process boundary, not just inside one process's device
simulation — the closest a single machine gets to a multi-host job."""

import os
import socket
import subprocess
import sys



def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_engine():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join("tests", "_dist_worker.py"),
             str(pid), str(port)],
            cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"proc {pid}: DIST-OK" in out, out[-3000:]
