"""The port's ViT backbone and MIL head against the JAX package's.

Every backbone output key, on converted weights, with and without the
token-axis padding (whose mid-sequence gap every softmax must mask).
f32 on both sides; tolerances scale with the activations (|x| up to ~20
after the blocks): f32 sums in another order through the blocks.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_support import (  # noqa: E402
    TINY, VITS, blob_inputs, ckpt3k_variables, inputs, jax_model, random_variables, torch_model)


def _backbone_outputs(kw, variables, img):
    from attentionshift_tpu.models.vit import VisionTransformerDet as JVit

    b = kw
    jvit = JVit(embed_dim=b["embed_dim"], depth=b["depth"], num_heads=b["num_heads"],
                out_indices=b.get("out_indices", (3, 5, 7, 11)),
                point_tokens_num=b["point_tokens"], num_classes=b["num_classes"],
                capture_layers=b["cam_layer"], use_remat=False,
                pad_tokens_to=b.get("pad_tokens_to", 0), drop_path_rate=0.0)
    jvars = {"params": variables["params"]["backbone"],
             "batch_stats": variables["batch_stats"]["backbone"]}
    want = jax.jit(lambda v, x: jvit.apply(v, x))(jvars, jnp.asarray(img))
    model = torch_model(variables, **kw)
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(img), with_features=True)
    return want, got


@pytest.mark.parametrize("pad_to", [0, 128])
@pytest.mark.parametrize("weights", ["random", "ckpt3k"])
def test_backbone_outputs_match_jax(weights, pad_to):
    if weights == "random":
        kw = dict(TINY, max_gt=4, pad_tokens_to=pad_to)
        args = inputs(64, 96, 4, 3)
        variables = random_variables(jax_model(**kw), args)
    else:
        kw = dict(VITS, max_gt=4, pad_tokens_to=pad_to)
        args = blob_inputs(64, 96, 4, 3)
        variables = ckpt3k_variables()
    want, got = _backbone_outputs(kw, variables, args[0])
    assert set(got) == set(want)
    t = 1 + 4 * 6 + kw["point_tokens"]
    t_pad = t + (-t % pad_to if pad_to else 0)
    assert got["attns"].shape == (kw["cam_layer"], 1, t_pad, t_pad)
    scale = float(np.abs(np.asarray(want["last_feat"])).max())
    for key in ("point_tokens", "last_feat", "org_feats", "outputs_class"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=2e-6 * max(scale, 1.0) * kw["depth"], err_msg=key)
    np.testing.assert_allclose(got["outputs_coord"].numpy(), np.asarray(want["outputs_coord"]),
                               atol=1e-5)
    # probabilities: 1e-6 absolute; the gap columns exactly 0
    np.testing.assert_allclose(got["attns"].numpy(), np.asarray(want["attns"]), atol=1e-6)
    if pad_to:
        lo = 1 + 4 * 6
        assert float(got["attns"][..., lo:t_pad - kw["point_tokens"]].abs().max()) == 0.0
    for i, (a, b) in enumerate(zip(got["feature"], want["feature"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6 * max(scale, 1.0) * 24,
                                   err_msg=f"feature[{i}]")


def test_mil_head_matches_jax():
    """Best layer exact; bag loss 1e-5 (f32 softmax/log chain)."""
    from attentionshift_torch.models.heads import MILHead
    from attentionshift_tpu.models.heads import MILHead as JMIL

    rs = np.random.RandomState(0)
    g, l, cin = 6, 7, 64
    feats = rs.randn(g, l, 7, 7, cin).astype(np.float32)
    lbl = rs.randint(0, 20, g).astype(np.int32)
    valid = np.arange(g) < 4
    jm = JMIL(num_classes=20, in_channels=cin, num_layers_query=l)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                                            jnp.asarray(lbl), jnp.asarray(valid)))
    params = jax.tree.map(lambda s: (0.05 * rs.randn(*s.shape)).astype(np.float32), shapes)
    want_idx, want_loss = jm.apply(params, jnp.asarray(feats), jnp.asarray(lbl),
                                   jnp.asarray(valid))
    head = MILHead(num_classes=20, in_channels=cin)
    from attentionshift_torch.convert import flax_to_torch

    sd = flax_to_torch({"params": {"mil_head": params["params"]}})
    head.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        idx, loss = head(*map(torch.from_numpy, (feats, lbl, valid)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
