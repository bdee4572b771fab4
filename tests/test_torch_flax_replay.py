"""The numpy replay of flax's ``model.init`` against JAX, on the CPU.

``attentionshift_torch/models/flax_replay.py`` recomputes the JAX tool's
initial weights without JAX: Threefry-2x32 keys folded from each scope's
path, the uniform, normal and truncated-normal formulas, XLA's f32
``log1p`` and ``erf_inv``. Held here to JAX 0.9.0 / flax 0.12.3:

- the primitives (``fold_in``, ``split``, ``random_bits``, ``uniform``,
  ``normal``, ``truncated_normal``, ``erf_inv``) bitwise;
- the learning check's model cut to 4 blocks (the FPN taps four) for keys
  0 and 3, leaf by leaf against ``model.init``: paths and shapes exact,
  values bitwise (tolerance 0 ulps: the replay follows XLA's CPU
  arithmetic, fused multiply-adds included);
- the committed manifest (``attentionshift_torch/tools/fixtures/
  flax_init_manifest.json``) against what ``build_manifest`` lists from
  JAX now at full depth, the replay of key 0 against its fingerprint, and
  key 1's replay, the control, which must miss it.

The manifest lists, for the JAX learning check's flagship, each
``params`` leaf's flax path, shape, position among its scope's
``make_rng("params")`` calls and initialiser with its arguments, read by
watching flax's ``Scope.param`` during ``model.init`` on the CPU (the card
has no JAX), with a fingerprint of key 0's values. Run as a script, this
file writes it:

    python tests/test_torch_flax_replay.py [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.core import scope as flax_scope  # noqa: E402

from attentionshift_torch.models import flax_replay  # noqa: E402

# the learning check's flagship (tools/analysis/learning_check.py) and its
# init inputs: batch 1 at 512 x 512, 8 point slots
LEARNING_MODEL = dict(num_classes=20, embed_dim=384, depth=12, num_heads=6, img_size=224,
                      point_tokens=100, cam_layer=7, max_gt=8, use_remat=True,
                      num_proposals=512, rpn_nms_pre=1000, rcnn_samples=256, mask_sample_cap=64)
H, W, G = 512, 512, 8


def model_of(**over):
    """The learning check's ``AttnShiftDetector`` (bf16, plain XLA: the
    parameter tree does not depend on the Pallas switches), with
    ``over`` replacing its arguments."""
    from attentionshift_tpu.models.detector import AttnShiftDetector

    kw = dict(LEARNING_MODEL, **over)
    return AttnShiftDetector(use_pallas_attention=False, use_pallas_ccl=False,
                             dtype=jnp.bfloat16, **kw)


def jax_init(model, key: int) -> dict:
    """``model.init`` as the JAX tool calls it (one key for every stream,
    under ``jax.jit``), as numpy."""
    init = jax.jit(lambda k: model.init(
        {"params": k, "sampling": k, "dropout": k}, jnp.zeros((1, H, W, 3), jnp.float32),
        jnp.zeros((1, G, 2)), jnp.zeros((1, G), jnp.int32), jnp.zeros((1, G), bool),
        jnp.asarray([[float(W), float(H)]])))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(key)))


def _rule(init_fn) -> dict:
    """The manifest's rule of a flax initialiser: its kind and arguments,
    read from the closure ``jax.nn.initializers`` builds."""
    name = getattr(init_fn, "__qualname__", "")
    free = dict(zip(init_fn.__code__.co_freevars,
                    (c.cell_contents for c in init_fn.__closure__ or ())))
    if name in ("zeros", "ones"):
        return {"kind": name}
    if name == "variance_scaling.<locals>.init":
        return {"kind": "variance_scaling", "scale": float(free["scale"]), "mode": free["mode"],
                "distribution": free["distribution"], "in_axis": int(free["in_axis"]),
                "out_axis": int(free["out_axis"])}
    if name == "truncated_normal.<locals>.init":
        return {"kind": "truncated_normal", "stddev": float(free["stddev"]),
                "lower": float(free["lower"]), "upper": float(free["upper"])}
    if name == "normal.<locals>.init":
        return {"kind": "normal", "stddev": float(free["stddev"])}
    raise ValueError(f"flax manifest: unknown initialiser {name} {free}")


def watch_init(model, key: int) -> tuple[list, dict]:
    """(leaves, variables): every ``params`` leaf as ``model.init`` creates
    it, with the scope path its key is folded from and its counter, and
    the variables themselves."""
    seen = []
    orig = flax_scope.Scope.param

    def param(self, name, init_fn, *args, unbox=True, **kw):
        if not self.has_variable("params", name):
            lazy = self.rngs["params"]
            seen.append(dict(path="/".join(("params",) + self.path + (name,)),
                             fold=list(lazy.suffix), counter=self.rng_counters["params"] + 1,
                             rule=_rule(init_fn)))
        return orig(self, name, init_fn, *args, unbox=unbox, **kw)

    flax_scope.Scope.param = param
    try:
        variables = jax_init(model, key)
    finally:
        flax_scope.Scope.param = orig
    return seen, variables


def build_manifest(key: int = 0, **over) -> tuple[dict, dict]:
    """(manifest, JAX's variables for ``key``) of the learning check's
    model (with ``over``)."""
    seen, variables = watch_init(model_of(**over), key)
    shapes = dict(flax_replay.flatten(jax.tree.map(lambda a: list(a.shape), variables,
                                                   is_leaf=lambda a: isinstance(a, np.ndarray))))
    leaves = []
    for leaf in seen:
        fold_path = leaf["path"].split("/")[1:-1]
        if leaf.pop("fold") != fold_path:  # the replay folds the scope path itself
            raise ValueError(f"{leaf['path']}: its key is not folded from its own scope path")
        leaves.append(dict(leaf, shape=shapes[leaf["path"]]))
    for path, value in flax_replay.flatten(variables):
        if not path.startswith("params/"):  # batch statistics: constants
            kind = "zeros" if not np.any(value) else "ones"
            assert np.all(value == (0.0 if kind == "zeros" else 1.0)), path
            leaves.append(dict(path=path, counter=None, rule={"kind": kind},
                               shape=list(value.shape)))
    if sorted(p for p, _ in flax_replay.flatten(variables)) != sorted(x["path"] for x in leaves):
        raise ValueError("flax manifest: a leaf was not seen being created")
    manifest = dict(
        source="tools/analysis/learning_check.py: AttnShiftDetector(%s) .init(PRNGKey(k)) on "
               "(1, %d, %d, 3)" % (", ".join(f"{k}={v}" for k, v in
                                            sorted(dict(LEARNING_MODEL, **over).items())), H, W),
        jax=jax.__version__, threefry_partitionable=bool(jax.config.jax_threefry_partitionable),
        leaves=leaves, fingerprint_key=key, fingerprint=flax_replay.fingerprint(variables))
    return manifest, variables


SMALL = dict(depth=4, out_indices=(0, 1, 2, 3), cam_layer=2)


def _bitwise(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (
        f"{what}: {int((got != want).sum())} of {got.size} differ")


def test_threefry_keys_and_bits_are_jax_bitwise():
    for seed in (0, 3, 2**31 - 1):
        key = flax_replay.prng_key(seed)
        _bitwise(key, jax.random.PRNGKey(seed), f"PRNGKey({seed})")
        for data in (0, 1, 123456, 2**32 - 1):
            _bitwise(flax_replay.fold_in(key, data),
                     jax.random.fold_in(jax.random.PRNGKey(seed), data),
                     f"fold_in({seed}, {data})")
        _bitwise(flax_replay.split(key, 5), jax.random.split(jax.random.PRNGKey(seed), 5),
                 "split")
        _bitwise(flax_replay.random_bits(key, (3, 7, 5)),
                 jax.random.bits(jax.random.PRNGKey(seed), (3, 7, 5)), "bits")


def test_draws_and_erf_inv_are_jax_bitwise():
    key, jkey = flax_replay.prng_key(11), jax.random.PRNGKey(11)
    shape = (257, 129)
    _bitwise(flax_replay.uniform(key, shape, -1.0, 1.0),
             jax.jit(lambda k: jax.random.uniform(k, shape, jnp.float32, -1.0, 1.0))(jkey),
             "uniform")
    _bitwise(flax_replay.normal(key, shape),
             jax.jit(lambda k: jax.random.normal(k, shape))(jkey), "normal")
    _bitwise(flax_replay.truncated_normal(key, -2.0, 2.0, shape),
             jax.jit(lambda k: jax.random.truncated_normal(k, -2.0, 2.0, shape))(jkey),
             "truncated_normal")
    u = flax_replay.uniform(flax_replay.prng_key(5), (400_000,),
                            np.nextafter(np.float32(-1), np.float32(0)), 1.0)
    _bitwise(flax_replay.erf_inv(u), jax.jit(jax.lax.erf_inv)(jnp.asarray(u)), "erf_inv")
    for bound in (-2.0, 2.0):
        _bitwise(flax_replay._ERF_AT[bound],
                 jax.jit(jax.lax.erf)(jnp.float32(bound) / jnp.float32(np.sqrt(2.0))),
                 f"erf({bound} / sqrt 2)")


@pytest.fixture(scope="module")
def small():
    manifest, v0 = build_manifest(0, **SMALL)
    return manifest, {0: v0, 3: jax_init(model_of(**SMALL), 3)}


@pytest.mark.parametrize("key", [0, 3])
def test_replay_equals_model_init(small, key):
    manifest, jax_vars = small
    got = dict(flax_replay.flatten(flax_replay.replay_variables(manifest, key)))
    want = dict(flax_replay.flatten(jax_vars[key]))
    assert list(got) == list(want)
    for path, w in want.items():
        _bitwise(got[path], w, f"key {key} {path}")


def test_replay_of_another_key_misses_the_fingerprint(small):
    manifest, _ = small
    assert flax_replay.fingerprint_mismatches(flax_replay.replay_variables(manifest, 0),
                                              manifest["fingerprint"]) == []
    missed = flax_replay.fingerprint_mismatches(flax_replay.replay_variables(manifest, 1),
                                                manifest["fingerprint"])
    drawn = [x["path"] for x in manifest["leaves"]
             if x["rule"]["kind"] not in ("zeros", "ones")]
    assert sorted(m.split(":")[0] for m in missed) == sorted(drawn)


def test_committed_manifest_is_what_jax_lists_now():
    """Full depth: leaves (paths, shapes, counters, rules) and the key-0
    fingerprint as JAX gives them now, and the replay of the committed
    manifest matches its own fingerprint."""
    committed = flax_replay.load_manifest()
    manifest, _ = build_manifest(0)
    assert committed["leaves"] == manifest["leaves"]
    assert committed["fingerprint"] == manifest["fingerprint"]
    assert committed["source"] == manifest["source"]
    replayed = flax_replay.replay_variables(committed, committed["fingerprint_key"])
    assert flax_replay.fingerprint_mismatches(replayed, committed["fingerprint"], ulps=0) == []


def main(argv=None) -> None:
    """Write the manifest (``--out``, default the committed file)."""
    ap = argparse.ArgumentParser(description="write the manifest of the JAX learning "
                                             "check's parameter tree")
    ap.add_argument("--out", default=flax_replay.MANIFEST)
    args = ap.parse_args(argv)
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    manifest, _ = build_manifest(0)
    with open(args.out, "w") as f:
        json.dump(manifest, f, indent=0, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out}: {len(manifest['leaves'])} leaves")


if __name__ == "__main__":
    main()
