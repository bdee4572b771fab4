"""The port's NMS (a bounded ``while_loop`` fixpoint with fixed-size outputs)
against the JAX package's ``nms`` and ``batched_nms``, exactly, on the CPU.

Cases: a suppression chain as long as the input (the fixpoint's worst
case: each iteration settles one more box), tied scores, invalid and
-inf candidates, every candidate invalid, ``max_out`` above N, a single
box, and row blocks smaller than N.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

jn = importlib.import_module("attentionshift_tpu.ops.nms")  # the package exports the function


def chain(n: int, ties: bool = False):
    """``n`` boxes 10 wide, each shifted 3 from the last (IoU 0.54 with its
    neighbour, 0.25 with the next but one), scores falling along the
    chain (or all equal: index order decides): greedy keeps every other
    box, and the fixpoint needs n iterations."""
    x = np.arange(n, dtype=np.float32) * 3.0
    bx = np.stack([x, np.zeros(n), x + 10.0, np.full(n, 10.0)], 1).astype(np.float32)
    sc = np.ones(n, np.float32) if ties else np.linspace(1.0, 0.1, n).astype(np.float32)
    return bx, sc


def clusters(seed: int, n: int):
    rs = np.random.RandomState(seed)
    xy = rs.rand(8, 2) * 80
    centres = np.concatenate([xy, xy + 10 + rs.rand(8, 2) * 30], 1)
    bx = (centres[rs.randint(0, 8, n)] + rs.randn(n, 4) * 2).astype(np.float32)
    sc = (np.round(rs.rand(n) * 10) / 10).astype(np.float32)  # ties
    return bx, sc, rs


CASES = {
    "chain": lambda: (*chain(40), None),
    "chain_ties": lambda: (*chain(33, ties=True), None),
    "clusters_invalid": lambda: (lambda b, s, rs: (b, s, rs.rand(len(s)) > 0.3))(*clusters(1, 70)),
    "minus_inf_scores": lambda: (lambda b, s, rs: (b, np.where(rs.rand(len(s)) > 0.5, s, -np.inf)
                                                   .astype(np.float32), None))(*clusters(2, 30)),
    "all_invalid": lambda: (*clusters(3, 20)[:2], np.zeros(20, bool)),
    "single": lambda: (np.array([[1, 2, 5, 9]], np.float32), np.array([0.3], np.float32), None),
}


@pytest.mark.parametrize("max_out", [4, 100])
@pytest.mark.parametrize("case", sorted(CASES))
def test_nms_matches_jax_exactly(case, max_out):
    from attentionshift_torch.ops.nms import nms

    bx, sc, val = CASES[case]()
    tv = None if val is None else torch.from_numpy(val)
    got = nms(torch.from_numpy(bx), torch.from_numpy(sc), 0.5, max_out, valid=tv, block=16)
    want = jn.nms(jnp.asarray(bx), jnp.asarray(sc), 0.5, max_out,
                  valid=None if val is None else jnp.asarray(val))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    assert tuple(got[0].shape) == tuple(got[1].shape) == (max_out,)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if case == "chain":
        assert got[0][: min(max_out, 20)].tolist() == list(range(0, 2 * min(max_out, 20), 2))
    if case == "all_invalid":
        assert not got[1].any() and not got[0].any()


@pytest.mark.parametrize("case", ["clusters_invalid", "chain"])
def test_batched_nms_matches_jax_exactly(case):
    from attentionshift_torch.ops.nms import batched_nms

    bx, sc, val = CASES[case]()
    ids = np.random.RandomState(4).randint(0, 3, len(sc)).astype(np.int32)
    tv = None if val is None else torch.from_numpy(val)
    got = batched_nms(torch.from_numpy(bx), torch.from_numpy(sc), torch.from_numpy(ids), 0.5,
                      len(sc) + 5, valid=tv)
    want = jn.batched_nms(jnp.asarray(bx), jnp.asarray(sc), jnp.asarray(ids), 0.5, len(sc) + 5,
                          valid=None if val is None else jnp.asarray(val))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_nms_loop_is_one_graph_operator():
    """Exported, the fixpoint is one ``while_loop`` of the graph (no host
    read, no data-dependent shape), and the program gives the eager
    result."""
    from attentionshift_torch.ops.nms import nms

    class Nms(torch.nn.Module):
        def forward(self, bx, sc):
            return nms(bx, sc, 0.5, 30, block=16)

    bx, sc, _ = CASES["clusters_invalid"]()
    args = (torch.from_numpy(bx), torch.from_numpy(sc))
    program = torch.export.export(Nms(), args)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("while_loop") == 1
    assert not [t for t in targets if "nonzero" in t or "_local_scalar_dense" in t]
    got, want = program.module()(*args), nms(*args, 0.5, 30, block=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
