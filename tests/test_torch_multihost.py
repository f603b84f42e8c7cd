"""The port's multi-host tier (folve_tpu_torch/parallel/multihost.py)
against the JAX package's, on the CPU at the sizes of
``tests/test_multihost.py``: two simulated hosts over a mesh of eight CPU
entries (the JAX side on its virtual 8-device mesh), the JAX test's
join/pause schedule, slot reset, a partial final block, and a real
two-process ``torch.distributed`` run over ``gloo``.

Run as a script, this file is one worker of that two-process run:
``python tests/test_torch_multihost.py RANK PORT BANK.npz OUT.npz``.
"""

import os
import socket
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch
from torch import distributed as dist

from folve_tpu_torch.convert import bank_from_numpy, state_to_numpy
from folve_tpu_torch.engine.stream import chunk_step, init_state
from folve_tpu_torch.parallel import multihost as tmh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8
TIMEOUT_S = 120
ATOL_JAX = 2e-4      # port against JAX, as for the sharded step
ATOL_ENGINE = 1e-5   # slot server against its own package's chunk_step
ATOL_PROCS = 1e-6    # two processes against one, as the JAX test

torch.set_num_threads(1)


def _jax_bank(rng, size=512, fragm=128):
    from folve_tpu.engine import compile_filter_bank

    ir = rng.standard_normal((2, 2, size)).astype(np.float32) / 16
    return compile_filter_bank(ir, fragm=fragm, size=size)


def _port_bank(jbank):
    return bank_from_numpy(np.asarray(jbank.h_spec), jbank.fragm, jbank.size,
                           device="cpu")


def _meshes(freq=2):
    import jax

    from folve_tpu.parallel.multihost import make_multihost_serving_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return (make_multihost_serving_mesh(n_hosts=2, freq_parallel=freq),
            tmh.make_multihost_serving_mesh(n_hosts=2, freq_parallel=freq,
                                            devices=CPU8))


def _servers(jbank, s_local, t, freq=2):
    from folve_tpu.parallel.multihost import SlotServer

    jmesh, mesh = _meshes(freq)
    return (SlotServer(jmesh, jbank, s_local=s_local, t=t),
            tmh.SlotServer(mesh, _port_bank(jbank), s_local=s_local, t=t))


def _states(jsrv, srv):
    for name in ("_hist_re", "_hist_im", "_tail", "_max"):
        yield name, np.asarray(getattr(jsrv, name)), getattr(srv, name).numpy()


@pytest.mark.parametrize("kind", ["cpu8", "indexed"])
def test_mesh_groups_hosts_by_list_position(kind):
    jmesh, _ = _meshes()
    devices = CPU8 if kind == "cpu8" else [torch.device("cpu", i) for i in range(8)]
    mesh = tmh.make_multihost_serving_mesh(n_hosts=2, freq_parallel=2,
                                           devices=devices)
    assert mesh.shape == dict(jmesh.shape) == {"host": 2, "stream": 2, "freq": 2}
    assert mesh.local_hosts == (0, 1)
    jdevs = np.asarray(jmesh.devices, dtype=object)
    for h in range(2):
        got = [d for row in mesh.hosts[h].devices for d in row]
        want = [devices[i] for i in range(4 * h, 4 * h + 4)]
        assert got == [torch.device(d) for d in want]
        # The JAX mesh's host h holds devices {4h..4h+3}: the same list
        # positions as the port's.
        assert sorted(d.id for d in jdevs[h].ravel()) == list(range(4 * h, 4 * h + 4))
        if kind == "indexed":
            assert [d.index for d in got] == [d.id for d in jdevs[h].ravel()]


@pytest.mark.parametrize("kwargs,match", [
    (dict(n_hosts=3, freq_parallel=1), "8 devices not divisible by 3 hosts"),
    (dict(n_hosts=2, freq_parallel=3), "4 devices/host not divisible by freq_parallel=3"),
])
def test_mesh_rejects_what_jax_rejects(kwargs, match):
    from folve_tpu.parallel.multihost import make_multihost_serving_mesh

    with pytest.raises(ValueError, match=match):
        make_multihost_serving_mesh(**kwargs)
    with pytest.raises(ValueError, match=match):
        tmh.make_multihost_serving_mesh(devices=CPU8, **kwargs)


def test_mesh_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        tmh.make_multihost_serving_mesh(n_hosts=2)


def _forbid_distributed(monkeypatch):
    """Make every public ``torch.distributed`` function raise."""
    def banned(name):
        def call(*a, **k):
            raise AssertionError(f"torch.distributed.{name} called")
        return call

    for name in dir(dist):
        if not name.startswith("_") and callable(getattr(dist, name)) and \
                not isinstance(getattr(dist, name), type):
            monkeypatch.setattr(dist, name, banned(name))


@pytest.mark.parametrize("freq", [1, 2])
def test_state_stays_on_its_host_and_tick_calls_no_collective(rng, monkeypatch, freq):
    """The counterpart of test_collectives_never_span_hosts: every host's
    state and output are arrays of that host's own ServingMesh, and
    neither a tick nor a reset calls torch.distributed."""
    _, mesh = _meshes(freq)
    s_local = 4 // freq
    bank = _port_bank(_jax_bank(rng))
    srv = tmh.SlotServer(mesh, bank, s_local=s_local, t=2)
    _forbid_distributed(monkeypatch)
    x = rng.standard_normal((2, 2, bank.fragm)).astype(np.float32)
    ys = srv.tick({r: x for r in range(2 * s_local)})
    srv.reset_slot(1)
    assert sorted(ys) == list(range(2 * s_local))
    monkeypatch.undo()
    for arr in (srv._h, srv._hist_re, srv._hist_im, srv._tail, srv._max):
        assert sorted(arr.parts) == [0, 1]
        for h, part in arr.parts.items():
            assert part.mesh is mesh.hosts[h]
            devs = {p.device for row in part.parts for p in row}
            assert devs == {torch.device("cpu")}
            assert len(part.parts) == mesh.shape["stream"]


def test_slot_server_matches_jax_and_chunk_step(rng):
    """The JAX test's schedule: 4 slots over 2 hosts, 4 ticks, slot 3
    joins at tick 1 and slot 1 pauses during tick 2."""
    jbank = _jax_bank(rng)
    t, n_ticks, s = 2, 4, 4
    jsrv, srv = _servers(jbank, s_local=2, t=t)
    xs = rng.standard_normal((n_ticks, s, t, 2, jbank.fragm)).astype(np.float32)
    progress = [0] * s
    got = [[] for _ in range(s)]
    for tick in range(n_ticks):
        rows = [r for r in range(s)
                if not (r == 3 and tick < 1) and not (r == 1 and tick == 2)]
        blocks = {r: xs[progress[r], r] for r in rows}
        jys, ys = jsrv.tick(blocks), srv.tick(blocks)
        assert sorted(ys) == rows
        for r in rows:
            np.testing.assert_allclose(ys[r], np.asarray(jys[r]), atol=ATOL_JAX,
                                       err_msg=f"slot {r} tick {tick}")
            got[r].append((progress[r], ys[r]))
            progress[r] += 1
    for name, j, p in _states(jsrv, srv):
        np.testing.assert_allclose(p, j, atol=ATOL_JAX, err_msg=name)
    bank = srv.bank
    for r in range(s):
        st = init_state(bank, device="cpu")
        for step_i, (i, y) in enumerate(got[r]):
            assert i == step_i  # a paused slot did not advance
            st, ref = chunk_step(bank, st, xs[i, r], t * bank.fragm)
            np.testing.assert_allclose(y, ref.numpy(), atol=ATOL_ENGINE,
                                       err_msg=f"slot {r} step {i}")


def test_slot_reset_reclaims_for_new_stream(rng):
    jbank = _jax_bank(rng)
    jsrv, srv = _servers(jbank, s_local=2, t=2)
    x1 = rng.standard_normal((2, 2, 2, jbank.fragm)).astype(np.float32)
    for blk in x1:  # stream A uses slot 0 for two blocks
        jsrv.tick({0: blk})
        srv.tick({0: blk})
    jsrv.reset_slot(0)
    srv.reset_slot(0)
    xb = rng.standard_normal((2, 2, jbank.fragm)).astype(np.float32)
    jy, y = np.asarray(jsrv.tick({0: xb})[0]), srv.tick({0: xb})[0]
    np.testing.assert_allclose(y, jy, atol=ATOL_JAX)
    _, ref = chunk_step(srv.bank, init_state(srv.bank, device="cpu"), xb,
                        2 * jbank.fragm)
    np.testing.assert_allclose(y, ref.numpy(), atol=ATOL_ENGINE)


@pytest.mark.parametrize("row", [0, 3, 4, 5, -1, -4, -5, 100])
def test_reset_slot_rows_as_jax(rng, row):
    """``reset_slot`` zeroes the rows JAX's ``.at[row].set(0.0)`` zeroes:
    a negative row counts from the end once, a row out of range changes
    nothing."""
    jbank = _jax_bank(rng)
    jsrv, srv = _servers(jbank, s_local=2, t=2)
    x = rng.standard_normal((4, 2, 2, jbank.fragm)).astype(np.float32)
    blocks = {r: x[r] for r in range(4)}
    jsrv.tick(blocks)
    srv.tick(blocks)
    before = {name: p.copy() for name, _, p in _states(jsrv, srv)}
    jsrv.reset_slot(row)
    srv.reset_slot(row)
    for name, j, p in _states(jsrv, srv):
        zeroed = [r for r in range(4) if not np.any(j[r]) and np.any(before[name][r])]
        assert [r for r in range(4) if not np.any(p[r]) and np.any(before[name][r])] == zeroed
        np.testing.assert_allclose(p, j, atol=ATOL_JAX, err_msg=name)
        kept = [r for r in range(4) if r not in zeroed]
        np.testing.assert_array_equal(p[kept], before[name][kept])


def test_partial_final_block_n_valid(rng):
    jbank = _jax_bank(rng)
    t = 2
    jsrv, srv = _servers(jbank, s_local=2, t=t)
    x = rng.standard_normal((t, 2, jbank.fragm)).astype(np.float32)
    nv = t * jbank.fragm - 77
    jy, y = np.asarray(jsrv.tick({2: x}, n_valid={2: nv})[2]), srv.tick({2: x}, n_valid={2: nv})[2]
    np.testing.assert_allclose(y, jy, atol=ATOL_JAX)
    st, ref = chunk_step(srv.bank, init_state(srv.bank, device="cpu"), x, nv)
    np.testing.assert_allclose(y, ref.numpy(), atol=ATOL_ENGINE)
    np.testing.assert_allclose(srv._max.numpy()[2], state_to_numpy(st)[3], atol=ATOL_ENGINE)
    for name, j, p in _states(jsrv, srv):
        np.testing.assert_allclose(p, j, atol=ATOL_JAX, err_msg=name)


# --- two processes over torch.distributed (gloo) ----------------------------

S_LOCAL, T, N_TICKS = 2, 2, 3


def _feed(tick: int, rows) -> dict:
    """The JAX worker's feed: every row, but the second row of each host
    idles at tick 2."""
    from tests._slotserver_worker import make_inputs

    return {row: make_inputs(row, tick, T, 2, 4096) for row in rows
            if not (tick == 2 and row % S_LOCAL == 1)}


def _bank_4096(rng):
    from folve_tpu.engine.filter_bank import compile_filter_bank

    size = 4096
    ir = (rng.standard_normal((2, 2, size)) / np.sqrt(size)).astype(np.float32)
    return compile_filter_bank(ir)


def _worker(rank: int, port: int, bank_path: str, out_path: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        with np.load(bank_path) as z:
            bank = bank_from_numpy(z["h_spec"], int(z["fragm"]), int(z["size"]),
                                   device="cpu")
        for kwargs, match in ((dict(n_hosts=3), "2 processes != n_hosts=3"),
                              (dict(devices=["cpu"] * (2 + 2 * rank)),
                               "hosts expose unequal device counts")):
            try:
                tmh.make_multihost_serving_mesh(freq_parallel=2, **{
                    "devices": ["cpu"] * 2, **kwargs})
            except ValueError as e:
                assert match in str(e), e
            else:
                raise AssertionError(f"no ValueError for {kwargs}")
        mesh = tmh.make_multihost_serving_mesh(freq_parallel=2, devices=["cpu"] * 2)
        assert mesh.shape == {"host": 2, "stream": 1, "freq": 2}, mesh.shape
        assert mesh.local_hosts == (rank,)
        srv = tmh.SlotServer(mesh, bank, s_local=S_LOCAL, t=T)
        assert srv.host_index == rank
        rows = range(rank * S_LOCAL, (rank + 1) * S_LOCAL)
        calls = []
        real = {name: getattr(dist, name) for name in dir(dist)
                if not name.startswith("_") and callable(getattr(dist, name))
                and not isinstance(getattr(dist, name), type)}

        def counted(name):
            def call(*a, **k):
                calls.append(name)
                return real[name](*a, **k)
            return call

        outs = {}
        for tick in range(N_TICKS):
            x_blocks = _feed(tick, rows)
            for name in real:
                setattr(dist, name, counted(name))
            try:
                y = srv.tick(x_blocks)
                srv.reset_slot(99)
            finally:
                for name, fn in real.items():
                    setattr(dist, name, fn)
            assert sorted(y) == sorted(x_blocks)
            for row, blk in y.items():
                outs[f"r{row}_t{tick}"] = blk
        assert not calls, calls
        other = (1 - rank) * S_LOCAL
        try:
            srv.tick({other: np.zeros((T, 2, bank.fragm), np.float32)})
        except ValueError as e:
            assert f"but was fed [{other}]" in str(e), e
        else:
            raise AssertionError("a row of the other host was accepted")
        np.savez(out_path, **outs)
    finally:
        dist.destroy_process_group()
    print("WORKER_OK", rank, flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_match_one_process_and_jax(tmp_path):
    """Two real processes, each one host of stream 1 x freq 2 on the
    CPU, feeding only their own rows; their outputs equal the port's
    one-process run within 1e-6 (the JAX test's tolerance) and the JAX
    virtual mesh's within 2e-4."""
    import jax

    from folve_tpu.parallel.multihost import SlotServer, make_multihost_serving_mesh

    jbank = _bank_4096(np.random.default_rng(5))
    bank_path = str(tmp_path / "bank.npz")
    np.savez(bank_path, h_spec=np.asarray(jbank.h_spec), fragm=jbank.fragm,
             size=jbank.size)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = [str(tmp_path / f"w{r}.npz") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port), bank_path, outs[r]],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    logs = []
    try:
        for r, proc in enumerate(procs):
            out, _ = proc.communicate(timeout=TIMEOUT_S)
            logs.append(out.decode(errors="replace"))
            assert proc.returncode == 0, f"worker {r} failed:\n{logs[-1]}"
            assert "WORKER_OK" in logs[-1]
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    got = {}
    for path in outs:
        with np.load(path) as z:
            got.update({k: z[k] for k in z.files})

    mesh = tmh.make_multihost_serving_mesh(n_hosts=2, freq_parallel=2, devices=["cpu"] * 4)
    srv = tmh.SlotServer(mesh, _port_bank(jbank), s_local=S_LOCAL, t=T)
    jmesh = make_multihost_serving_mesh(n_hosts=2, freq_parallel=2,
                                        devices=jax.devices()[:4])
    jsrv = SlotServer(jmesh, jbank, s_local=S_LOCAL, t=T)
    one, ref = {}, {}
    for tick in range(N_TICKS):
        x_blocks = _feed(tick, range(2 * S_LOCAL))
        one.update({f"r{r}_t{tick}": y for r, y in srv.tick(x_blocks).items()})
        ref.update({f"r{r}_t{tick}": np.asarray(y) for r, y in jsrv.tick(x_blocks).items()})
    assert sorted(got) == sorted(one) == sorted(ref)
    for k in sorted(one):
        np.testing.assert_allclose(got[k], one[k], atol=ATOL_PROCS, err_msg=k)
        np.testing.assert_allclose(got[k], ref[k], atol=ATOL_JAX, err_msg=k)


if __name__ == "__main__":
    torch.set_num_threads(1)
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
