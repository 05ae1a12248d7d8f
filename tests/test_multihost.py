"""Tests for the multi-host tier (parallel/multihost.py).

pod_mesh is exercised over synthetic (n_hosts, n_local, rows_per_host)
topologies built from the 8 virtual CPU devices; a two-process
jax.distributed smoke test validates initialize_distributed against a real
coordination service when the environment allows it.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax

from ug_stereomatcher.parallel.multihost import (
    distributed_config,
    initialize_distributed,
    pod_mesh,
)


DEVS = jax.devices()


def _host_of(dev, n_local):
    return dev.id // n_local


class TestPodMesh:
    @pytest.mark.parametrize("n_local,rows_per_host", [
        (8, None),   # 1 host, all-local rows axis
        (8, 4),
        (4, 2),      # 2 hosts x 4 chips, rows=2
        (4, 4),      # rows axis = whole host
        (2, 1),      # degenerate rows axis
        (1, 1),      # 8 hosts x 1 chip
    ])
    def test_shapes_and_axes(self, n_local, rows_per_host):
        mesh = pod_mesh(rows_per_host, devices=DEVS, n_local=n_local)
        assert mesh.axis_names == ("pairs", "rows")
        rph = rows_per_host or n_local
        n_hosts = len(DEVS) // n_local
        assert mesh.shape["rows"] == rph
        assert mesh.shape["pairs"] == n_hosts * n_local // rph
        assert mesh.shape["pairs"] * mesh.shape["rows"] == len(DEVS)

    def test_rows_axis_is_ici_contiguous(self):
        """Each rows-group must be consecutive devices of a single host —
        the axis that carries halo exchanges must never cross DCN."""
        for n_local, rph in [(4, 2), (4, 4), (8, 2), (2, 2), (8, 8)]:
            mesh = pod_mesh(rph, devices=DEVS, n_local=n_local)
            grid = np.array(mesh.devices)
            for row in grid:  # one (pairs) slice = one rows-group
                ids = [d.id for d in row]
                hosts = {_host_of(d, n_local) for d in row}
                assert len(hosts) == 1, f"rows group spans hosts: {ids}"
                assert ids == list(range(ids[0], ids[0] + len(ids)))

    def test_all_devices_used_once(self):
        for n_local, rph in [(4, 2), (8, 4), (2, 1)]:
            mesh = pod_mesh(rph, devices=DEVS, n_local=n_local)
            ids = sorted(d.id for d in np.array(mesh.devices).flat)
            assert ids == [d.id for d in DEVS]

    def test_non_divisor_rows_clamped_down(self):
        # rows_per_host=3 does not divide n_local=4 -> clamps to 2
        mesh = pod_mesh(3, devices=DEVS, n_local=4)
        assert mesh.shape["rows"] == 2
        assert mesh.shape["pairs"] == 4

    def test_oversized_rows_clamped_to_local(self):
        # rows axis may never exceed one host's chips
        mesh = pod_mesh(16, devices=DEVS, n_local=4)
        assert mesh.shape["rows"] == 4

    def test_ragged_topology_truncated(self):
        # 7 devices at n_local=4 -> only 1 complete host is usable
        mesh = pod_mesh(None, devices=DEVS[:7], n_local=4)
        assert mesh.shape["pairs"] * mesh.shape["rows"] == 4

    def test_mesh_runs_a_collective(self):
        """The constructed mesh is usable: psum over 'pairs' sees every
        shard and ppermute over 'rows' stays within host groups."""
        from jax.sharding import PartitionSpec as P

        mesh = pod_mesh(2, devices=DEVS, n_local=4)
        x = np.arange(mesh.shape["pairs"], dtype=np.float32)

        def body(v):
            return jax.lax.psum(v, "pairs")

        try:
            fn = jax.shard_map(body, mesh=mesh, in_specs=P("pairs"),
                               out_specs=P(), check_vma=False)
        except TypeError:  # pragma: no cover - older jax
            fn = jax.shard_map(body, mesh=mesh, in_specs=P("pairs"),
                               out_specs=P(), check_rep=False)
        out = np.asarray(fn(x))
        np.testing.assert_allclose(out, x.sum())


class TestDistributedConfig:
    def test_defaults_unconfigured(self, monkeypatch):
        for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                  "JAX_PROCESS_ID"):
            monkeypatch.delenv(k, raising=False)
        addr, kw = distributed_config()
        assert addr is None and kw == {}
        assert initialize_distributed() is False

    def test_env_parsing(self, monkeypatch):
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
        monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
        monkeypatch.setenv("JAX_PROCESS_ID", "2")
        addr, kw = distributed_config()
        assert addr == "10.0.0.1:1234"
        assert kw == {"num_processes": 4, "process_id": 2}

    def test_explicit_args_win(self, monkeypatch):
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
        monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
        addr, kw = distributed_config("other:9", num_processes=2,
                                      process_id=0)
        assert addr == "other:9"
        assert kw == {"num_processes": 2, "process_id": 0}


_WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from ug_stereomatcher.parallel.multihost import (
        initialize_distributed, pod_mesh)
    active = initialize_distributed()
    assert active, "expected multi-process mode"
    assert jax.process_count() == 2, jax.process_count()
    mesh = pod_mesh()
    assert mesh.axis_names == ("pairs", "rows")
    assert mesh.shape["pairs"] * mesh.shape["rows"] == len(jax.devices())
    print("OK", jax.process_index(), mesh.shape)
""")


@pytest.mark.slow
def test_two_process_distributed_smoke(tmp_path):
    """Real jax.distributed bootstrap: two CPU processes, one coordinator.
    Skips if the environment forbids local sockets."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env_base = {**os.environ,
                "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                "JAX_NUM_PROCESSES": "2",
                "PYTHONPATH": os.path.dirname(os.path.dirname(__file__))}
    env_base.pop("XLA_FLAGS", None)  # 1 local device per process
    procs = []
    for pid in range(2):
        env = {**env_base, "JAX_PROCESS_ID": str(pid)}
        procs.append(subprocess.Popen(
            [sys.executable, str(script)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("distributed bootstrap timed out in this environment")
    for rc, out in outs:
        if rc != 0 and ("UNAVAILABLE" in out or "PermissionError" in out
                        or "DEADLINE" in out):
            pytest.skip(f"environment blocks local sockets: {out[-200:]}")
        assert rc == 0, out
        assert "OK" in out


class _FakeDev:
    """Minimal stand-in with real-device metadata (process_index, id)."""

    def __init__(self, process_index, dev_id):
        self.process_index = process_index
        self.id = dev_id

    def __repr__(self):
        return f"d{self.process_index}.{self.id}"


class TestPodMeshScrambledOrder:
    def test_groups_by_process_not_list_order(self):
        """Device lists whose order interleaves hosts (some real
        topologies' id order) must still produce rows-groups confined to
        a single host."""
        # 2 hosts x 4 chips, interleaved list order h0,h1,h0,h1,...
        devs = []
        for i in range(4):
            devs.append(_FakeDev(0, i))
            devs.append(_FakeDev(1, 4 + i))
        mesh = pod_mesh(2, devices=devs, n_local=4)
        grid = np.array(mesh.devices)
        assert mesh.shape == {"pairs": 4, "rows": 2}
        for row in grid:
            hosts = {d.process_index for d in row}
            assert len(hosts) == 1, f"rows group spans hosts: {list(row)}"

    def test_within_host_id_order(self):
        devs = [_FakeDev(1, 7), _FakeDev(0, 2), _FakeDev(1, 5),
                _FakeDev(0, 0)]
        mesh = pod_mesh(2, devices=devs, n_local=2)
        grid = np.array(mesh.devices)
        ids = [[d.id for d in row] for row in grid]
        assert ids == [[0, 2], [5, 7]]
