"""The train variants' heads of the port against the JAX package.

``models/mae_head.py`` (``patchify``, ``MAEDecoderHead`` on the same
masking draw), ``models/heads.py``'s ``BoxHeadRec(with_reconstruct=True)``
and ``reconstruction_loss``, ``models/convert.py::mae_to_decoder_params``,
and ``models/condinst.py::SimpleCondInstHead``, each on converted flax
parameters and numpy inputs made from a seed, on the CPU.

Tolerances: losses to 1e-5 relative, head outputs to 1e-5 of their
largest entry (f32 sums in another order), parameter gradients to 2e-3 of
each tensor's largest entry, as ``test_torch_train_step_random.py``
holds the train step's.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_support import close  # noqa: E402

LOSS_REL = 1e-5
GRAD_REL = 2e-3


def _random_params(module, *args, seed: int = 0, scale: float = 0.05):
    """Flax parameters of ``module`` for ``args``, from numpy: N(0, scale),
    norm scales 1 + N(0, 0.1)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: ((1.0 + 0.1 * rs.randn(*s.shape)) if "scale" in jax.tree_util.keystr(p)
                      else scale * rs.randn(*s.shape)).astype(np.float32), shapes)


def _port_state(name: str, params) -> dict:
    """A flax head's parameters under the port's names, as the detector's
    ``name`` subtree converts them."""
    from attentionshift_torch.convert import flax_to_torch

    sd = flax_to_torch({"params": {name: jax.tree.map(np.asarray, params["params"])}})
    return {k.split(".", 1)[1]: v for k, v in sd.items()}


def _check_grads(port, loss, jgrads, name: str):
    params = list(port.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)  # unused: zero, as in JAX
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(port.named_parameters(), grads)}
    want = _port_state(name, jgrads)
    assert set(grads) == set(want)
    for k, ref in want.items():
        ref = ref.numpy()
        close(grads[k], ref, GRAD_REL * max(np.abs(ref).max(), 1e-12), what=f"grad {k}")
    return grads


# ------------------------------------------------------------------- MAE


def test_patchify_matches_jax():
    from attentionshift_torch.models.mae_head import patchify
    from attentionshift_tpu.models.mae_head import patchify as jpatchify

    img = np.random.RandomState(0).randn(2, 32, 48, 3).astype(np.float32)
    got = patchify(torch.from_numpy(img), 16).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpatchify(jnp.asarray(img), 16)))
    np.testing.assert_array_equal(got[0, 1, :3], img[0, 0, 16])  # second patch at column 16


@pytest.fixture(scope="module")
def mae_case():
    """The JAX ``MAEDecoderHead`` (2 blocks of 32 wide) on a 4x6 patch
    grid, its loss and gradients, with the masking uniforms replayed."""
    from attentionshift_torch.models.mae_head import MAEDecoderHead
    from attentionshift_tpu.models.mae_head import MAEDecoderHead as JHead

    b, hp, wp, din = 2, 4, 6, 48
    rs = np.random.RandomState(1)
    tokens = rs.randn(b, 1 + hp * wp, din).astype(np.float32)
    img = rs.randn(b, hp * 16, wp * 16, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jhead = JHead(in_channels=din, embed_dim=32, depth=2, num_heads=4)
    params = _random_params(jhead, jnp.asarray(tokens), jnp.asarray(img), key)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jhead.apply(p, jnp.asarray(tokens), jnp.asarray(img), key))(params)
    port = MAEDecoderHead(in_channels=din, embed_dim=32, depth=2, num_heads=4)
    port.load_state_dict(_port_state("mae_head", params), strict=True)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (b, hp * wp))))
    loss = port(torch.from_numpy(tokens), torch.from_numpy(img), noise=noise)
    return dict(port=port, loss=loss, jloss=float(jloss), jgrads=jgrads, tokens=tokens, img=img)


def test_mae_head_loss_matches_jax(mae_case):
    got, want = float(mae_case["loss"].detach()), mae_case["jloss"]
    assert want > 0
    close(got, want, LOSS_REL * want, what="loss_mae_rec")


def test_mae_head_gradients_match_jax(mae_case):
    grads = _check_grads(mae_case["port"], mae_case["loss"], mae_case["jgrads"], "mae_head")
    assert float(grads["mask_token"].abs().max()) > 0  # the masked slots reach the loss


def test_mae_head_masks_by_its_generator():
    """Without handed-in uniforms the head masks by its generator: the
    same seed gives the same loss, another seed another mask."""
    from attentionshift_torch.models.mae_head import MAEDecoderHead

    torch.manual_seed(0)
    head = MAEDecoderHead(in_channels=16, embed_dim=32, depth=1, num_heads=4)
    tokens, img = torch.randn(1, 1 + 12, 16), torch.randn(1, 48, 64, 3)
    loss = [float(head(tokens, img, generator=torch.Generator().manual_seed(s))) for s in (0, 0, 1)]
    assert loss[0] == loss[1] != loss[2]


# ------------------------------------------------- box head reconstruction


@pytest.fixture(scope="module")
def rec_case():
    from attentionshift_torch.models.heads import BoxHeadRec, reconstruction_loss
    from attentionshift_tpu.models.heads import BoxHeadRec as JBox
    from attentionshift_tpu.models.heads import reconstruction_loss as jrec

    rs = np.random.RandomState(2)
    r, s, cin = 4, 7, 48
    feats = rs.randn(r, s, s, cin).astype(np.float32)
    img = rs.randn(2, 96, 128, 3).astype(np.float32)
    rois = np.asarray([[0, 4, 6, 60, 70], [0, 30, 10, 120, 90], [1, 0, 0, 50, 50],
                       [1, 10, 20, 40, 30]], np.float32)
    valid = np.asarray([True, True, True, False])
    jhead = JBox(num_classes=5, in_channels=cin, embed_dim=32, depth=2, num_heads=4,
                 with_reconstruct=True)
    params = _random_params(jhead, jnp.asarray(feats))

    def jfn(p):
        cls, reg, rec = jhead.apply(p, jnp.asarray(feats))
        loss = jrec(rec, jnp.asarray(rois), jnp.asarray(img), jnp.asarray(valid))
        return loss, (cls, reg, rec)

    (jloss, jouts), jgrads = jax.value_and_grad(jfn, has_aux=True)(params)
    port = BoxHeadRec(num_classes=5, in_channels=cin, embed_dim=32, depth=2, num_heads=4,
                      with_reconstruct=True)
    port.load_state_dict(_port_state("bbox_head", params), strict=True)
    outs = port(torch.from_numpy(feats))
    loss = reconstruction_loss(outs[2], torch.from_numpy(rois), torch.from_numpy(img),
                               torch.from_numpy(valid))
    return dict(port=port, outs=outs, loss=loss, jouts=jouts, jloss=float(jloss), jgrads=jgrads)


def test_box_head_reconstruction_matches_jax(rec_case):
    for name, got, want in zip(("cls_score", "bbox_pred", "rec"), rec_case["outs"],
                               rec_case["jouts"]):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, name
        close(got.detach(), want, LOSS_REL * np.abs(want).max(), what=name)


def test_reconstruction_loss_and_gradients_match_jax(rec_case):
    close(float(rec_case["loss"].detach()), rec_case["jloss"], LOSS_REL * rec_case["jloss"],
          what="reconstruction_loss")
    grads = _check_grads(rec_case["port"], rec_case["loss"], rec_case["jgrads"], "bbox_head")
    assert float(grads["fc_rec.weight"].abs().max()) > 0


def test_mae_to_decoder_params_matches_jax():
    """An MAE decoder ``state_dict`` grafted onto a box head: the port's
    graft equals the JAX graft converted, and keys outside the decoder
    (``fc_cls``, ``det_token``) keep their values."""
    from attentionshift_torch.models.convert import mae_to_decoder_params
    from attentionshift_torch.models.heads import BoxHeadRec
    from attentionshift_tpu.models.convert import mae_to_decoder_params as jgraft
    from attentionshift_tpu.models.heads import BoxHeadRec as JBox

    cin, d = 48, 32
    feats = jnp.zeros((1, 7, 7, cin))
    jhead = JBox(num_classes=5, in_channels=cin, embed_dim=d, depth=2, num_heads=4)
    params = _random_params(jhead, feats)
    rs = np.random.RandomState(6)
    state = {"decoder_embed.weight": rs.randn(d, cin), "decoder_embed.bias": rs.randn(d),
             "norm.weight": rs.randn(cin), "norm.bias": rs.randn(cin),
             "decoder_pred.weight": rs.randn(768, d), "mask_token": rs.randn(1, 1, d)}
    for i in range(2):
        for n in ("norm1", "norm2"):
            state[f"decoder_blocks.{i}.{n}.weight"] = rs.randn(d)
            state[f"decoder_blocks.{i}.{n}.bias"] = rs.randn(d)
        for n, (o, k) in (("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                          ("mlp.fc1", (4 * d, d)), ("mlp.fc2", (d, 4 * d))):
            state[f"decoder_blocks.{i}.{n}.weight"] = rs.randn(o, k)
            state[f"decoder_blocks.{i}.{n}.bias"] = rs.randn(o)
    state = {k: v.astype(np.float32) for k, v in state.items()}
    want = _port_state("bbox_head", {"params": jgraft(state, jax.tree.map(
        np.asarray, params["params"]), depth=2)})
    port = BoxHeadRec(num_classes=5, in_channels=cin, embed_dim=d, depth=2, num_heads=4)
    before = _port_state("bbox_head", params)
    port.load_state_dict(before, strict=True)
    got = mae_to_decoder_params(state, port.state_dict(), depth=2)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    assert torch.equal(got["decoder_embed.weight"], torch.from_numpy(state["decoder_embed.weight"]))
    assert torch.equal(got["fc_cls.weight"], before["fc_cls.weight"])


# --------------------------------------------------------------- condinst


@pytest.mark.parametrize("batched", [False, True])
def test_condinst_head_loss_and_gradients_match_jax(batched):
    """The keypoint-align head with padded parts and a padded instance,
    unbatched (N, D) and batched (B, N, D): loss and every gradient."""
    from attentionshift_torch.models.condinst import SimpleCondInstHead
    from attentionshift_tpu.models.condinst import SimpleCondInstHead as JHead

    rs = np.random.RandomState(3)
    n, p, dt, dp = 4, 6, 16, 12
    lead = (2,) if batched else ()
    tok = rs.randn(*lead, n, dt).astype(np.float32)
    parts = rs.randn(*lead, p, dp).astype(np.float32)
    labels = rs.randint(0, n, lead + (p,)).astype(np.int32)
    pv = rs.rand(*lead, p) > 0.3
    tv = np.ones(lead + (n,), bool)
    tv[..., -1] = False
    args = (tok, parts, labels, pv, tv)
    jhead = JHead(feat_channels=8, num_layers=3, mlp_hidden=32)
    params = _random_params(jhead, *map(jnp.asarray, args), scale=0.2)
    jloss, jgrads = jax.value_and_grad(
        lambda v: jhead.apply(v, *map(jnp.asarray, args))["loss_keypoint_align"])(params)
    port = SimpleCondInstHead(dt, dp, feat_channels=8, num_layers=3, mlp_hidden=32)
    port.load_state_dict(_port_state("keypoint_align_head", params), strict=True)
    loss = port(*(torch.from_numpy(a) for a in args))["loss_keypoint_align"]
    assert float(jloss) > 0
    close(float(loss.detach()), float(jloss), LOSS_REL * float(jloss), what="loss_keypoint_align")
    _check_grads(port, loss, jgrads, "keypoint_align_head")
    none = port(*(torch.from_numpy(a) for a in (tok, parts, labels, np.zeros_like(pv), tv)))
    assert float(none["loss_keypoint_align"]) == 0.0  # no valid part: zero loss
