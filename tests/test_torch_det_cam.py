"""The port's detection CAMs, visualisation and the two visualisation tools
against the JAX package's, on the CPU.

``utils/det_cam.py``: ``det_box_score`` (the JAX test's cases, masks
included, and random boxes), ``eigen_cam`` and ``featmap_am``,
``grad_cam`` on a TINY detector with converted random weights (the focal
box is the JAX detector's own top detection), ``cam_on_image``.
``utils/visualize.py``: every function on the same inputs, and on
tensors. The tools ``browse_dataset`` and ``analysis/analyze_results``
through ``main(argv)`` against the JAX scripts (run with ``sys.argv``
set) on a synthetic VOC tree: ``analyze_results`` reads the
``--dump-preds`` pickle of the port's ``tools.test``.

Tolerances: scores to 1e-6 (a few f32 products); EigenCAM and FeatmapAM
to 1e-4 after their normalisation to [0, 1] (f32 means and an SVD in
another order); grad-CAM to 1e-3 after normalisation: its gradient
passes RoIAlign at the test-time proposals, whose coordinates the two
packages give to 1e-3 px (ROADMAP section C, "Test-time box
coordinates"), which moves the bilinear weights and so the gradient at
~1e-4 relative, and the map is a sum over channels of terms of both
signs (measured: 2.8e-4); images and pngs exactly (the same numpy and
PIL code on the same arrays). ``eigen_cam``'s
inputs have a clear gap between their first two singular values (rank
one plus 1 % noise): without a gap the first singular direction, and so
the map, is not defined.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_support import (EVAL_KW, REPO, close, inputs, jax_model,  # noqa: E402
                                random_variables, torch_model, voc_tree)

CAM_TOL = 1e-4
GRAD_CAM_TOL = 1e-3


def _jax_tool(relpath: str, argv: list, monkeypatch):
    """Run the JAX package's script ``relpath`` (its ``main()`` reads
    ``sys.argv``) in this process."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{os.path.basename(relpath)[:-3]}",
                                                  os.path.join(REPO, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [relpath] + argv)
    mod.main()


def _pngs(d) -> dict:
    from PIL import Image

    return {f: np.asarray(Image.open(os.path.join(d, f))) for f in sorted(os.listdir(d))}


def test_det_box_score_matches_jax():
    from attentionshift_torch.utils.det_cam import det_box_score
    from attentionshift_tpu.utils.det_cam import det_box_score as jscore

    det_boxes = np.asarray([[10.0, 10, 50, 50], [60, 60, 90, 90], [12, 8, 52, 47]], np.float32)
    det_scores = np.asarray([0.9, 0.8, 0.7], np.float32)
    det_labels = np.asarray([2, 5, 2], np.int32)
    m = np.zeros((3, 8, 8), np.float32)
    m[:, 2:6, 2:6] = 1.0
    m[2, :, :3] = 1.0
    cases = [
        (np.asarray([[10.0, 10, 50, 50]]), [2], True, False),  # IoU 1 + 0.9
        (np.asarray([[10.0, 10, 50, 50]]), [3], True, False),  # label mismatch: 0
        (np.asarray([[200.0, 200, 250, 250]]), [2], True, False),  # no overlap: 0
        (np.asarray([[10.0, 10, 50, 50]]), [2], True, True),  # + dice 0.5
        (np.asarray([[11.0, 9, 51, 48], [61, 58, 88, 91]]), [2, 5], False, True),  # one invalid
    ]
    for i, (fb, fl, all_valid, masks) in enumerate(cases):
        valid = np.asarray([True, True, all_valid])
        args = [det_boxes, det_scores, det_labels, valid, fb.astype(np.float32),
                np.asarray(fl, np.int32)]
        kw = dict(det_masks=m, focal_masks=m[:len(fl)]) if masks else {}
        want = float(jscore(*map(jnp.asarray, args), **{k: jnp.asarray(v) for k, v in kw.items()}))
        got = float(det_box_score(*map(torch.from_numpy, args),
                                  **{k: torch.from_numpy(v) for k, v in kw.items()}))
        close(got, want, 1e-6, what=f"case {i}")
    assert abs(want) > 0


def test_det_box_score_random_matches_jax():
    from attentionshift_torch.utils.det_cam import det_box_score
    from attentionshift_tpu.utils.det_cam import det_box_score as jscore

    rs = np.random.RandomState(3)
    xy = rs.rand(12, 2) * 60
    det = np.concatenate([xy, xy + 10 + rs.rand(12, 2) * 30], 1).astype(np.float32)
    focal = (det[[0, 3, 7, 9]] + rs.randn(4, 4) * 3).astype(np.float32)
    args = [det, rs.rand(12).astype(np.float32), rs.randint(0, 3, 12).astype(np.int32),
            rs.rand(12) > 0.2, focal, rs.randint(0, 3, 4).astype(np.int32)]
    args[-1][:2] = args[2][[0, 3]]
    for thr in (0.3, 0.5, 0.7):
        want = float(jscore(*map(jnp.asarray, args), match_iou_thr=thr))
        got = float(det_box_score(*map(torch.from_numpy, args), match_iou_thr=thr))
        close(got, want, 1e-6, what=f"thr {thr}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_eigen_cam_and_featmap_am_match_jax(seed):
    """Rank-one activations plus 1 % noise, so that sigma_1 / sigma_2 is
    large (asserted): the first singular direction is well defined."""
    from attentionshift_torch.utils.det_cam import eigen_cam, featmap_am
    from attentionshift_tpu.utils.det_cam import eigen_cam as jeigen
    from attentionshift_tpu.utils.det_cam import featmap_am as jfeat

    rs = np.random.RandomState(seed)
    pattern = rs.rand(6, 7).astype(np.float32)
    v = (rs.rand(16) - 0.3).astype(np.float32)
    acts = (v[:, None, None] * pattern[None] + 0.01 * rs.randn(16, 6, 7)).astype(np.float32)
    x = acts.reshape(16, -1).T
    sv = np.linalg.svd(x - x.mean(0), compute_uv=False)
    assert sv[0] > 10 * sv[1]
    close(eigen_cam(torch.from_numpy(acts)).numpy(), jeigen(acts), CAM_TOL)
    close(featmap_am(torch.from_numpy(acts)).numpy(), jfeat(acts), CAM_TOL)


def test_grad_cam_matches_jax(monkeypatch):
    """grad-CAM of the JAX detector's top valid detection on both packages'
    TINY detectors (same weights), and its overlay on the image. The JAX
    function runs as it is, with its ``jax.grad`` jitted (op by op it
    takes a minute)."""
    from attentionshift_torch.utils.det_cam import cam_on_image, grad_cam
    from attentionshift_tpu.utils.det_cam import cam_on_image as jcam_on_image
    from attentionshift_tpu.utils.det_cam import grad_cam as jgrad_cam

    h, w = 64, 96
    img, _, _, _, wh = inputs(h, w, 4, 3)
    jmodel = jax_model(**EVAL_KW)
    variables = random_variables(jmodel, inputs(h, w, 4, 3))
    port = torch_model(variables, **EVAL_KW)
    test = jax.jit(lambda v, x, s: jmodel.apply(v, x, s, method=type(jmodel).simple_test))
    dets = test(variables, jnp.asarray(img), jnp.asarray(wh)).dets
    valid = np.asarray(dets.valid[0])
    assert valid.any()
    k = int(valid.argmax())
    fb, fl = np.array(dets.boxes[0][k:k + 1]), np.array(dets.labels[0][k:k + 1])
    grad = jax.grad
    monkeypatch.setattr(jax, "grad", lambda f, *a, **kw: jax.jit(grad(f, *a, **kw)))
    want = jgrad_cam(jmodel, variables, jnp.asarray(img), jnp.asarray(wh), jnp.asarray(fb),
                     jnp.asarray(fl), match_iou_thr=0.1)
    got = grad_cam(port, torch.from_numpy(img), torch.from_numpy(wh), torch.from_numpy(fb),
                   torch.from_numpy(fl), match_iou_thr=0.1)
    assert tuple(got.shape) == (h // 16, w // 16) and float(got.max()) == 1.0
    close(got.numpy(), want, GRAD_CAM_TOL)
    pix = (np.random.RandomState(1).rand(h, w, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(cam_on_image(pix, torch.from_numpy(want)),
                                  jcam_on_image(pix, want))


def test_visualize_matches_jax(tmp_path):
    """The same pngs and arrays as the JAX copy, from numpy and from
    tensors."""
    from attentionshift_torch.utils import visualize as tv
    from attentionshift_tpu.utils import visualize as jv

    rs = np.random.RandomState(0)
    img = rs.randn(64, 64, 3).astype(np.float32)
    base = jv.denormalize(img)
    np.testing.assert_array_equal(tv.denormalize(torch.from_numpy(img)), base)
    heat = rs.rand(16, 16)
    np.testing.assert_array_equal(tv.overlay_heatmap(base, torch.from_numpy(heat)),
                                  jv.overlay_heatmap(base, heat))
    masks = np.zeros((2, 64, 64), bool)
    masks[0, 10:30, 5:20] = masks[1, 40:60, 30:50] = True
    kw = dict(labels=np.asarray([2, 7]), scores=np.asarray([0.8, 0.35]),
              points=np.asarray([[10.0, 10.0], [45.0, 50.0]]), masks=masks,
              class_names=[f"c{i}" for i in range(20)])
    boxes = np.asarray([[5, 5, 30, 30], [28, 38, 52, 62]], np.float32)
    want = jv.draw_detections(base, boxes, **kw)
    np.testing.assert_array_equal(tv.draw_detections(base, boxes, **kw), want)
    np.testing.assert_array_equal(
        tv.draw_detections(torch.from_numpy(base), torch.from_numpy(boxes),
                           **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                              for k, v in kw.items()}), want)
    aux = dict(pseudo_boxes=np.asarray([[5.0, 5.0, 30.0, 30.0], [0, 0, 0, 0]], np.float32),
               pseudo_valid=np.asarray([True, False]),
               pseudo_masks=masks.astype(np.uint8),
               semantic_centers=rs.rand(2, 3, 2).astype(np.float32) * 60,
               semantic_valid=np.asarray([[True, False, True], [False] * 3]),
               map_fg=rs.rand(2, 64, 64).astype(np.float32))
    jp = jv.dump_pseudo_labels(str(tmp_path / "jax"), "img0", img, aux)
    tp = tv.dump_pseudo_labels(str(tmp_path / "port"), "img0", torch.from_numpy(img),
                               {k: torch.from_numpy(v) for k, v in aux.items()})
    assert [os.path.basename(p) for p in tp] == [os.path.basename(p) for p in jp]
    assert len(tp) == 2
    for name, a in _pngs(tmp_path / "jax").items():
        np.testing.assert_array_equal(_pngs(tmp_path / "port")[name], a)


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return voc_tree(tmp_path_factory.mktemp("VOC2012"))


def test_browse_dataset_matches_jax_tool(voc, tmp_path, monkeypatch, capsys):
    from attentionshift_torch.tools import browse_dataset

    cfg = tmp_path / "browse.py"
    cfg.write_text(f"data = dict(train=dict(ann_file={voc['ann_file']!r}, "
                   f"img_prefix={voc['img_prefix']!r}), max_gt=4, flip_ratio=0.5, "
                   f"train_scales=[(96, 160), (64, 128)])\n")
    paths = browse_dataset.main([str(cfg), "--num", "3", "--out-dir", str(tmp_path / "port")])
    assert len(paths) == 2 and all(os.path.exists(p) for p in paths)  # the tree has 2 images
    _jax_tool("tools/browse_dataset.py", [str(cfg), "--num", "3", "--out-dir",
                                          str(tmp_path / "jax")], monkeypatch)
    got, want = _pngs(tmp_path / "port"), _pngs(tmp_path / "jax")
    assert sorted(got) == sorted(want) == ["sample_0.png", "sample_1.png"]
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
        assert got[name].std() > 0


def test_analyze_results_matches_jax_tool(voc, tmp_path, monkeypatch, capsys):
    """On the pickle of the port's ``tools.test --dump-preds``: the same good
    and bad pngs, byte for byte in pixels, as the JAX script writes."""
    from attentionshift_torch.models import AttnShiftDetector
    from attentionshift_torch.tools import test as cli
    from attentionshift_torch.tools.analysis import analyze_results
    from attentionshift_torch.train import save_params

    model = AttnShiftDetector(device="cpu", **EVAL_KW).init_weights(seed=3)
    ckpt = save_params(str(tmp_path / "epoch_1"), model.state_dict())
    cfg = tmp_path / "tiny_voc.py"
    cfg.write_text(f"model = dict(**{EVAL_KW!r})\n"
                   f"data = dict(val=dict(split_file={voc['split_file']!r}, "
                   f"voc_root={voc['voc_root']!r}), test_scale=(64, 96))\n")
    dump = tmp_path / "preds.pkl"
    cli.main([str(cfg), ckpt, "--device", "cpu", "--dump-preds", str(dump)])
    args = [str(dump), "--dataset-split", voc["split_file"], "--voc-root", voc["voc_root"],
            "-k", "2"]
    paths = analyze_results.main(args + ["--out", str(tmp_path / "port")])
    assert len(paths) == 4 and all(os.path.exists(p) for p in paths)
    _jax_tool("tools/analysis/analyze_results.py", args + ["--out", str(tmp_path / "jax")],
              monkeypatch)
    got, want = _pngs(tmp_path / "port"), _pngs(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(want) == 4
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
        assert got[name].std() > 0
    assert "wrote 4 overlays" in capsys.readouterr().out
