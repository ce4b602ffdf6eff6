"""One rank of a real `so_tpu_torch --distributed` run over gloo.

Launched once per rank by tests/test_torch_distributed.py, with torchrun's
variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) set:

    python torch_distributed_worker.py <check_port> [CLI args...]

With a check_port other than 0 the rank first joins a gloo group on that
port and holds the collectives of so_tpu_torch.parallel.distributed to
their contract (every rank's array, bits and dtype kept, lengths that
differ by rank), then leaves it. It then runs the port's CLI with the
given arguments and --distributed, on the group of MASTER_PORT.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from so_tpu_torch.cli import main  # noqa: E402
from so_tpu_torch.parallel import distributed as D  # noqa: E402


def rank_arrays(r: int) -> list:
    """Arrays of every dtype the run exchanges, of rank-dependent length."""
    rng = np.random.default_rng(100 + r)
    f64 = rng.normal(size=3 + r) * 1e300
    f64[:3] = [-0.0, np.inf, np.nan]
    return [
        (np.arange(5 + 2 * r, dtype=np.int64) - 3) * (1 << 40),
        rng.integers(-2**31, 2**31 - 1, 4 * r, dtype=np.int64).astype(
            np.int32),
        f64,
        rng.normal(size=7 - r).astype(np.float32),
        np.arange(r + 1, dtype=np.uint8) * 100,
        np.zeros(0, np.int64),
    ]


def check_collectives() -> None:
    W, r = dist.get_world_size(), dist.get_rank()
    mine = rank_arrays(r)
    for i, a in enumerate(mine):
        got = D.allgather_varlen(a)
        assert len(got) == W
        for p, g in enumerate(got):
            want = rank_arrays(p)[i]
            assert g.dtype == want.dtype, (i, g.dtype, want.dtype)
            assert g.tobytes() == want.tobytes(), (i, p)
    f = D.allgather_f64(np.full((3, 2), r + 0.1))
    assert f.shape == (W, 3, 2) and f.dtype == np.float64
    assert all((f[p] == p + 0.1).all() for p in range(W))
    tr = D.TorchTransport()
    assert (tr.nproc, tr.pid) == (W, r)
    b, i64 = tr.process_allgather((np.array([r % 2], np.uint8),
                                   np.array([[r, -r]], np.int64)))
    assert b.shape == (W, 1) and i64.shape == (W, 1, 2)
    assert [int(x) for x in i64[:, 0, 0]] == list(range(W))
    ts = [torch.tensor([True, r == 1]), None,
          torch.full((2, 3), float(r)), torch.arange(4) * (r + 1)]
    out = tr.allgather_tensors(ts)
    for p, row in enumerate(out):
        assert row[1] is None and row[0].dtype == torch.bool
        assert row[0].tolist() == [True, p == 1]
        assert (row[2] == p).all() and row[2].shape == (2, 3)
        assert row[3].tolist() == [k * (p + 1) for k in range(4)]
    tr.barrier()


if __name__ == "__main__":
    check_port, args = sys.argv[1], sys.argv[2:]
    if check_port != "0":
        port = os.environ["MASTER_PORT"]
        os.environ["MASTER_PORT"] = check_port
        assert D.init_distributed("gloo")
        check_collectives()
        dist.destroy_process_group()
        os.environ["MASTER_PORT"] = port
        print(f"COLLECTIVES_OK rank={os.environ['RANK']}", flush=True)
    assert main(args + ["--distributed"]) == 0
    print(f"TORCH_DISTRIBUTED_OK rank={os.environ['RANK']}", flush=True)
