"""The multi-controller mesh of the port (zotpu_torch/dist/mesh.py,
dist/shuffle.py's process helpers) with P = 2 processes x L = 2 CPU slots
on gloo, against the one-process mesh on 4 slots and numpy: all_to_all,
psum, allreduce, allgather with unequal lengths (one of them 0),
hosts_prefix_ordered, gather_local_rows and allgather_host_sets with
prefix and mixed owners, and the layout rules of init_distributed and
process_mesh. Tolerance: exact equality.

This file also holds what the other ``test_torch_multiproc_*.py`` files
share: ``spawn`` (processes with a timeout and a kill) and the worker that
runs a list of CLI commands in one process group. Run as a script it is
that worker:

    python tests/test_torch_multiproc_mesh.py MODE PID P PORT OUTDIR

MODE ``mesh`` runs the collectives below; MODE ``cli`` runs the commands
of OUTDIR/spec.json in order (in a group on the spec's device and
backend), each one's stdout to OUTDIR/cmd{j}.p{pid}.out and its exit code,
kernel launches, bytes sent and seconds to OUTDIR/rc.p{pid}.json: a CLI argv
(``zotpu_torch.cli.main`` with the multi-controller flags added),
``{"crash": kwargs}`` (the fault-injected sharded spill run),
``{"remove": path, "pid": p}`` (process p deletes a file) or
``{"mtimes": dir}`` (the modification times of dir's files, as JSON).
"""

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, L = 2, 2
D = P * L
C = 5
TIMEOUT = 120


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(argvs, timeout=TIMEOUT, cwd=None, env=None):
    """Start one process per argv together; wait at most ``timeout``
    seconds for each of them in turn, killing every one on expiry (a hang
    fails one test, not the suite). Returns [(returncode, output)].

    Every process's pipe is read from its own thread while they run: a
    process whose exit waits for its peers (NCCL's teardown does) would
    otherwise wait for a peer blocked on a full pipe that is read only
    after the first process has exited."""
    env = {**(env or os.environ), "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, *map(str, a)], env=env,
                              cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in argvs]
    outs = [""] * len(procs)

    def drain(i):
        with procs[i].stdout as f:
            outs[i] = f.read()

    readers = [threading.Thread(target=drain, args=(i,), daemon=True)
               for i in range(len(procs))]
    for t in readers:
        t.start()
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"processes still running after {timeout} s: {argvs}")
    finally:
        for t in readers:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in readers), "a pipe stayed open"
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def run_worker(mode, outdir, nproc=P, timeout=TIMEOUT):
    """Run this file as the worker of ``mode`` in nproc processes; every
    process must exit 0."""
    port = free_port()
    res = spawn([[__file__, mode, pid, nproc, port, outdir]
                 for pid in range(nproc)], timeout=timeout)
    for rc, out in res:
        assert rc == 0, out
    return res


def run_cli_commands(tmp_path, commands, nproc=P, device="cpu",
                     backend=None, info=False):
    """Run ``commands`` (each a CLI argv or a dict command of the worker)
    in order in one group of nproc processes; returns per command the list
    of (exit code, stdout) of each process, with ``info`` (exit code,
    stdout, {rc, launches, sent_bytes, seconds})."""
    out = tmp_path / f"run{free_port()}"
    out.mkdir()
    (out / "spec.json").write_text(json.dumps(
        {"device": device, "backend": backend,
         "commands": [c if isinstance(c, dict) else [str(a) for a in c]
                      for c in commands]}))
    run_worker("cli", out, nproc=nproc)
    recs = [json.loads((out / f"rc.p{p}.json").read_text())
            for p in range(nproc)]
    return [[(r[j]["rc"], (out / f"cmd{j}.p{p}.out").read_text(),
              r[j])[:3 if info else 2] for p, r in enumerate(recs)]
            for j in range(len(commands))]


# -- the worker -------------------------------------------------------------

def _sends(seed, n_slots, c):
    """Slot i's (D, C) send buffer: a distinct int64 per element."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(-1 << 40, 1 << 40, (D, c)))
            for _ in range(n_slots)]


def _global_set(seed=3, n=3000, k=15):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << (2 * k), n, dtype=np.uint64))
    return keys, rng.integers(1, 1 << 31, len(keys)).astype(np.uint32)


def _slot_rows(keys, counts, shard_hash, k=15):
    """The global set split over D slots by the owner function."""
    from zotpu_torch.dist import shuffle as TS
    rows, _ = TS.partition_panel(keys, k, D, shard_hash=shard_hash)
    pos = {int(x): i for i, x in enumerate(keys)}
    out = []
    for r in rows:
        kd = r[r != np.iinfo(np.int64).max]
        out.append((kd, counts[[pos[int(x)] for x in kd]].astype(np.int64)))
    return out


def _mesh_worker(pid, nproc, port, outdir):
    import torch.distributed as dist

    from zotpu_torch.dist import mesh as M
    from zotpu_torch.dist import shuffle as TS

    dev = M.init_distributed(f"127.0.0.1:{port}", nproc, pid, "cpu")
    res = {"device": str(dev)}
    res["same_group_again"] = str(M.init_distributed(
        f"127.0.0.1:{port}", nproc, pid, "cpu"))
    try:
        M.init_distributed(f"127.0.0.1:{port}", nproc + 1, pid, "cpu")
    except ValueError as e:
        res["mismatch"] = str(e)
    mesh = M.process_mesh(D, "cpu")
    res.update(size=mesh.size, first=mesh.first, multi=mesh.multi,
               owners=list(mesh.owners), ordered=TS.hosts_prefix_ordered(mesh),
               shards2=len(M.process_mesh(2, "cpu").devices),
               multi_controller=M.multi_controller())
    for bad in (3, 1, 6):
        try:
            M.process_mesh(bad, "cpu")
        except ValueError as e:
            res[f"bad{bad}"] = str(e)
    local = range(mesh.first, mesh.first + L)
    sends = _sends(11, D, C)
    M.reset_sent_bytes()
    recv = mesh.all_to_all([sends[i] for i in local])
    res["a2a_bytes"] = M.sent_bytes()
    arrays = {f"recv{d}": r.numpy() for d, r in zip(local, recv)}
    xs = [torch.arange(6, dtype=torch.int32) * (d + 1) for d in local]
    arrays["psum"] = torch.stack(mesh.psum(xs)).numpy()
    v = torch.tensor([pid + 1, -pid], dtype=torch.int64)
    for op in ("sum", "max", "min"):
        arrays[f"allreduce_{op}"] = mesh.allreduce(v, op).numpy()
    arrays["allreduce_input"] = v.numpy()
    # unequal lengths, one of them 0, and two columns
    mine = torch.arange(5 * (1 - pid), dtype=torch.int64) + 100 * pid
    arrays["allgather"] = mesh.allgather(mine).numpy()
    arrays["allgather2"] = mesh.allgather(
        torch.stack([mine, -mine], dim=1)).numpy()
    keys, counts = _global_set()
    for shard_hash in ("prefix", "mixed"):
        rows = _slot_rows(keys, counts, shard_hash)
        mixed = shard_hash == "mixed"
        lk, lc = TS.gather_local_rows([rows[d][0] for d in local],
                                      [rows[d][1] for d in local],
                                      [len(rows[d][0]) for d in local],
                                      reorder=mixed)
        gk, gc = TS.allgather_host_sets(mesh, lk, lc, reorder=mixed)
        arrays.update({f"{shard_hash}_local_keys": lk,
                       f"{shard_hash}_local_counts": lc,
                       f"{shard_hash}_keys": gk, f"{shard_hash}_counts": gc})
    ek, ec = TS.allgather_host_sets(mesh, np.empty(0, np.uint64),
                                    np.empty(0, np.uint32))
    res["empty"] = [len(ek), len(ec), str(ek.dtype), str(ec.dtype)]
    np.savez(os.path.join(outdir, f"mesh.p{pid}.npz"), **arrays)
    with open(os.path.join(outdir, f"mesh.p{pid}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def _cli_worker(pid, nproc, port, outdir):
    import contextlib
    import io
    import time

    import torch.distributed as dist

    from zotpu_torch import cli, kernels
    from zotpu_torch.dist import mesh as M
    from zotpu_torch.workloads import kmerize as W

    with open(os.path.join(outdir, "spec.json")) as f:
        spec = json.load(f)
    coord = f"127.0.0.1:{port}"
    dev = M.init_distributed(coord, nproc, pid, spec["device"],
                             backend=spec["backend"])
    flags = ["--coordinator", coord, "--num-processes", str(nproc),
             "--process-id", str(pid)]
    rcs = []
    for j, cmd in enumerate(spec["commands"]):
        buf = io.StringIO()
        rc = 0
        kernels.reset_launches()
        M.reset_sent_bytes()
        t0 = time.perf_counter()
        if isinstance(cmd, dict) and "remove" in cmd:
            if cmd["pid"] == pid:
                os.remove(cmd["remove"])
        elif isinstance(cmd, dict) and "mtimes" in cmd:
            d = cmd["mtimes"]
            json.dump({n: os.stat(os.path.join(d, n)).st_mtime_ns
                       for n in sorted(os.listdir(d))}, buf)
        elif isinstance(cmd, dict):   # the fault-injected spill run
            kw = cmd["crash"]
            try:
                W.kmerize_paths_sharded(
                    kw["paths"][pid::nproc], kw["k"], kw["shards"],
                    batch_reads=kw["batch_reads"], max_len=kw["max_len"],
                    spill_dir=kw["spill_dir"], shard_hash=kw["shard_hash"],
                    fail_after_batches=kw["fail_after"], device=dev)
                rc = 0
            except W.Interrupted as e:
                buf.write(str(e))
                rc = 3
        else:
            with contextlib.redirect_stdout(buf):
                rc = cli.main(cmd + flags)
        rcs.append({"rc": rc, "launches": kernels.launches(),
                    "sent_bytes": M.sent_bytes(),
                    "seconds": time.perf_counter() - t0})
        with open(os.path.join(outdir, f"cmd{j}.p{pid}.out"), "w") as f:
            f.write(buf.getvalue())
    with open(os.path.join(outdir, f"rc.p{pid}.json"), "w") as f:
        json.dump(rcs, f)
    # the CLI left the caller's group in place
    assert dist.is_initialized()
    dist.destroy_process_group()


# -- the tests --------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    run_worker("mesh", out)
    res = [json.loads((out / f"mesh.p{p}.json").read_text())
           for p in range(P)]
    arrays = [dict(np.load(out / f"mesh.p{p}.npz")) for p in range(P)]
    return res, arrays


def test_layout(mesh_run):
    res, _ = mesh_run
    for pid, r in enumerate(res):
        assert r["device"] == r["same_group_again"] == "cpu"
        assert "size 2 and rank" in r["mismatch"]
        assert r["size"] == D and r["first"] == pid * L and r["multi"]
        assert r["owners"] == [0, 0, 1, 1] and r["ordered"] is True
        assert r["shards2"] == 1 and r["multi_controller"] is True
        for bad in (3, 1, 6):
            assert r[f"bad{bad}"] == (f"--shards {bad} must be a power of "
                                      f"two and a multiple of "
                                      f"--num-processes 2")


def test_all_to_all_equals_the_one_process_mesh(mesh_run):
    from zotpu_torch.dist import mesh as M
    res, arrays = mesh_run
    want = M.Mesh(["cpu"] * D).all_to_all(_sends(11, D, C))
    for pid in range(P):
        for d in range(pid * L, pid * L + L):
            assert np.array_equal(arrays[pid][f"recv{d}"], want[d].numpy())
        # half of each slot's (D, C) int64 buffer goes to the other process
        assert res[pid]["a2a_bytes"] == L * D * C * 8 // 2


def test_psum_and_allreduce(mesh_run):
    _, arrays = mesh_run
    want = sum(np.arange(6, dtype=np.int32) * (d + 1) for d in range(D))
    ins = [a["allreduce_input"] for a in arrays]
    for a in arrays:
        assert a["psum"].dtype == np.int32
        assert np.array_equal(a["psum"], np.stack([want] * L))
        assert np.array_equal(a["allreduce_sum"], sum(ins))
        assert np.array_equal(a["allreduce_max"], np.maximum(*ins))
        assert np.array_equal(a["allreduce_min"], np.minimum(*ins))


def test_allgather_unequal_lengths(mesh_run):
    res, arrays = mesh_run
    want = np.arange(5, dtype=np.int64)    # process 1 contributes nothing
    for r, a in zip(res, arrays):
        assert np.array_equal(a["allgather"], want)
        assert np.array_equal(a["allgather2"], np.stack([want, -want], 1))
        assert r["empty"] == [0, 0, "uint64", "uint32"]


@pytest.mark.parametrize("shard_hash", ["prefix", "mixed"])
def test_gather_local_rows_and_allgather_host_sets(mesh_run, shard_hash):
    """Each process's rows, then the global set on every process: equal to
    the numpy set the slots were cut from, sorted in both layouts."""
    _, arrays = mesh_run
    keys, counts = _global_set()
    rows = _slot_rows(keys, counts, shard_hash)
    for pid, a in enumerate(arrays):
        lk = np.concatenate([rows[d][0] for d in range(pid * L,
                                                       pid * L + L)])
        order = np.argsort(lk) if shard_hash == "mixed" else slice(None)
        assert np.array_equal(a[f"{shard_hash}_local_keys"],
                              lk.astype(np.uint64)[order])
        assert np.array_equal(a[f"{shard_hash}_keys"], keys)
        assert np.array_equal(a[f"{shard_hash}_counts"], counts)
        assert a[f"{shard_hash}_counts"].dtype == np.uint32


def test_hosts_prefix_ordered_against_the_jax_rule():
    """The port's rule on slot owner lists, including layouts no port mesh
    makes (interleaved, descending), against a numpy statement of it, and
    JAX's hosts_prefix_ordered on the 8-fake-device mesh (one process)."""
    from types import SimpleNamespace

    from zotpu.dist import mesh as JM
    from zotpu.dist import shuffle as JS
    from zotpu_torch.dist import mesh as M
    from zotpu_torch.dist import shuffle as TS

    def numpy_rule(owners):
        o = np.asarray(owners)
        firsts = [np.flatnonzero(o == p) for p in np.unique(o)]
        return all(np.all(np.diff(f) == 1) for f in firsts) and all(
            a[-1] < b[0] for a, b in zip(firsts, firsts[1:]))

    for owners in ([0, 0, 1, 1], [0, 1, 0, 1], [1, 1, 0, 0], [0, 0, 0, 0],
                   [0, 1, 1, 0], [0, 1, 2, 3], [0, 0, 2, 2, 1, 1, 3, 3]):
        got = TS.hosts_prefix_ordered(SimpleNamespace(owners=owners))
        assert got == numpy_rule(owners), owners
    assert TS.hosts_prefix_ordered(M.make_mesh(4, device="cpu")) is True
    assert JS.hosts_prefix_ordered(JM.make_mesh(8)) is True


if __name__ == "__main__":
    mode, pid, nproc, port, outdir = sys.argv[1:6]
    torch.set_num_threads(1)
    {"mesh": _mesh_worker, "cli": _cli_worker}[mode](
        int(pid), int(nproc), port, outdir)
