"""The port's object detection (``analytics_zoo_tpu_torch/models/image/
objectdetection``) held to the JAX package at ``ssd-lite`` width on the
CPU: every case of ``tests/test_object_detection.py`` on the port, then
the port against the JAX functions on the same inputs, with the JAX
model's weights carried across by name.

Tolerances: the discrete choices (priors, NMS keep-masks, matching,
hard-negative mining, detection labels and order, the static int8
products) are held equal; the box coordinates of a detection table 1e-6
absolute (the same decode, XLA free to contract a product into an FMA);
forwards, losses and gradients 1e-5 relative and 1e-6 absolute (the same
f32 arithmetic summed in another order); a 2-epoch fit's losses and
parameters 1e-4 relative and 1e-5 absolute (two epochs of Adam carry
those differences forward).
"""

import os
import subprocess
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.common import context as jctx
from analytics_zoo_tpu.models.image.objectdetection import bbox as jbbox
from analytics_zoo_tpu.models.image.objectdetection import \
    multibox_loss as jmbl
from analytics_zoo_tpu.models.image.objectdetection import \
    ObjectDetector as JDetector
from analytics_zoo_tpu.models.image.objectdetection import \
    priors as jpriors
from analytics_zoo_tpu.pipeline.api.keras import engine as jeng
from analytics_zoo_tpu.pipeline.inference import InferenceModel as JaxIM
from analytics_zoo_tpu_torch.common import context as pctx
from analytics_zoo_tpu_torch.models.common.zoo_model import load_model
from analytics_zoo_tpu_torch.models.image.objectdetection import (
    DetectionOutputParam, MeanAveragePrecision, MultiBoxLoss,
    ObjectDetector, PriorBox, average_precision, batched_detection_output,
    bbox_iou, decode_boxes, encode_boxes, match_priors, nms_mask, ssd_lite,
    ssd_priors, ssd_vgg)
from analytics_zoo_tpu_torch.models.image.objectdetection.multibox_loss \
    import hard_negatives
from analytics_zoo_tpu_torch.ops import nms as pnms
from analytics_zoo_tpu_torch.ops.pallas import quantized as pq
from analytics_zoo_tpu_torch.pipeline.api.keras import engine as peng
from analytics_zoo_tpu_torch.pipeline.api.keras.training import _param_tree
from analytics_zoo_tpu_torch.pipeline.inference import InferenceModel

RTOL, ATOL = 1e-5, 1e-6
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
RES, CLASSES = 64, 3


@pytest.fixture(autouse=True)
def contexts():
    pctx.reset_zoo_context()
    pctx.init_zoo_context(conf={"zoo.seed": 0})
    peng.reset_uids()
    jeng.reset_uids()
    jctx.init_zoo_context(conf={"zoo.seed": 0})
    yield
    pctx.reset_zoo_context()
    jctx.reset_zoo_context()


def _tree(t):
    return jax.tree.map(np.asarray, t)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _naive_iou(a, b):
    out = np.zeros((len(a), len(b)))
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            lt = np.maximum(x[:2], y[:2])
            rb = np.minimum(x[2:], y[2:])
            wh = np.clip(rb - lt, 0, None)
            inter = wh[0] * wh[1]
            ua = ((x[2] - x[0]) * (x[3] - x[1])
                  + (y[2] - y[0]) * (y[3] - y[1]) - inter)
            out[i, j] = inter / ua if ua > 0 else 0.0
    return out


def _rand_boxes(rng, n):
    xy = rng.uniform(0, 0.7, size=(n, 2))
    wh = rng.uniform(0.05, 0.3, size=(n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _pair(classes=CLASSES, res=RES, seed=0, batch=2):
    """The JAX ``ssd-lite`` detector on seeded weights and the port's with
    them carried across by name."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, res, res, 3)).astype(np.float32)
    jd = JDetector("ssd-lite", num_classes=classes, resolution=res)
    jd.init_weights(sample_input=x)
    pd = ObjectDetector("ssd-lite", num_classes=classes, resolution=res,
                        device="cpu").load_jax_params(_tree(jd.params))
    return jd, pd, x


def _square_images(rng, n, res, max_gt=3):
    """Images with one bright square each, and its padded gt table."""
    images = rng.normal(0, 0.05, size=(n, res, res, 3)).astype(np.float32)
    gt = np.full((n, max_gt, 5), -1.0, np.float32)
    for i in range(n):
        size = int(rng.integers(res // 5, res // 2))
        x0 = int(rng.integers(0, res - size))
        y0 = int(rng.integers(0, res - size))
        images[i, y0:y0 + size, x0:x0 + size, :] = 1.0
        gt[i, 0] = [1, x0 / res, y0 / res, (x0 + size) / res,
                    (y0 + size) / res]
    return images, gt


# ---------------------------------------------------------------------------
# the cases of tests/test_object_detection.py, on the port
# ---------------------------------------------------------------------------

def test_iou_matches_naive():
    rng = np.random.default_rng(0)
    a, b = _rand_boxes(rng, 7), _rand_boxes(rng, 5)
    np.testing.assert_allclose(bbox_iou(a, b).numpy(), _naive_iou(a, b),
                               rtol=1e-5, atol=1e-6)


def test_encode_decode_roundtrip():
    rng = np.random.default_rng(1)
    priors = _rand_boxes(rng, 20)
    gt = _rand_boxes(rng, 20)
    dec = decode_boxes(encode_boxes(gt, priors), priors).numpy()
    np.testing.assert_allclose(dec, gt, rtol=1e-4, atol=1e-5)


def test_nms_matches_naive():
    rng = np.random.default_rng(2)
    boxes = _rand_boxes(rng, 40)
    scores = rng.uniform(size=40).astype(np.float32)
    order = np.argsort(-scores)
    boxes_s = boxes[order]
    keep = nms_mask(boxes_s, 0.5).numpy()
    iou = _naive_iou(boxes_s, boxes_s)
    naive_keep = np.ones(40, bool)
    for i in range(40):
        if not naive_keep[i]:
            continue
        for j in range(i + 1, 40):
            if iou[i, j] > 0.5:
                naive_keep[j] = False
    np.testing.assert_array_equal(keep, naive_keep)


def test_match_priors_forced_assignment():
    """A gt with max IoU below the threshold still gets its best prior."""
    priors = np.array([[0.0, 0.0, 0.4, 0.4],
                       [0.5, 0.5, 0.9, 0.9],
                       [0.1, 0.6, 0.3, 0.9]], np.float32)
    gt = np.array([[1, 0.05, 0.05, 0.45, 0.45],
                   [2, 0.45, 0.45, 0.55, 0.55],
                   [-1, 0, 0, 0, 0]], np.float32)
    gt_idx, pos = (t.numpy() for t in match_priors(gt, priors, 0.5))
    assert pos[0] and gt_idx[0] == 0
    forced_prior = int(np.argmax(_naive_iou(priors, gt[1:2, 1:5])[:, 0]))
    assert pos[forced_prior] and gt_idx[forced_prior] == 1
    assert pos.sum() == 2


def test_multibox_loss_prefers_correct_output():
    rng = np.random.default_rng(3)
    priors = _rand_boxes(rng, 30)
    loss = MultiBoxLoss(num_classes=3, priors=priors)
    gt = np.array([[[1, *priors[4]], [2, *priors[17]]]], np.float32)
    perfect = np.zeros((1, 30, 7), np.float32)
    perfect[..., 4] = 8.0
    perfect[0, 4, 4:] = [0, 8, 0]
    perfect[0, 17, 4:] = [0, 0, 8]
    bad = np.zeros((1, 30, 7), np.float32)
    bad[..., 5] = 8.0
    l_good = float(loss(gt, _t(perfect)))
    l_bad = float(loss(gt, _t(bad)))
    assert l_good < 0.1
    assert l_bad > l_good + 1.0


def test_hard_negative_mining_ratio():
    """With 1 positive, at most ceil(3*1) negatives contribute conf loss."""
    rng = np.random.default_rng(4)
    priors = _rand_boxes(rng, 50)
    loss = MultiBoxLoss(num_classes=2, priors=priors, neg_pos_ratio=3.0)
    gt = np.zeros((1, 1, 5), np.float32)
    gt[0, 0] = [1, *priors[0]]
    val = float(loss(gt, torch.zeros(1, 50, 6)))
    assert abs(val - 4 * np.log(2.0)) < 1e-3


def test_detection_output_shapes_and_nms():
    rng = np.random.default_rng(5)
    priors = _rand_boxes(rng, 30)
    loc = np.zeros((2, 30, 4), np.float32)
    conf = np.full((2, 30, 3), 0.01, np.float32)
    conf[0, 7, 1] = 0.95
    conf[1, 3, 2] = 0.9
    conf[1, 21, 2] = 0.85
    det = batched_detection_output(loc, conf, priors, num_classes=3,
                                   conf_thresh=0.5, keep_topk=10).numpy()
    assert det.shape == (2, 10, 6)
    assert det[0, 0, 0] == 1 and abs(det[0, 0, 1] - 0.95) < 1e-5
    np.testing.assert_allclose(det[0, 0, 2:], np.clip(priors[7], 0, 1),
                               atol=1e-5)
    assert (det[0, 1:, 0] == -1).all()
    assert det[1, 0, 0] == 2 and det[1, 1, 0] == 2


def test_detection_output_suppresses_overlaps():
    priors = np.array([[0.1, 0.1, 0.5, 0.5],
                       [0.12, 0.12, 0.52, 0.52],
                       [0.6, 0.6, 0.9, 0.9]], np.float32)
    loc = np.zeros((1, 3, 4), np.float32)
    conf = np.zeros((1, 3, 2), np.float32)
    conf[0, :, 1] = [0.9, 0.8, 0.7]
    det = batched_detection_output(loc, conf, priors, num_classes=2,
                                   conf_thresh=0.5, nms_thresh=0.45,
                                   keep_topk=3).numpy()
    labels = det[0, :, 0]
    assert (labels >= 0).sum() == 2
    assert abs(det[0, 0, 1] - 0.9) < 1e-6 and abs(det[0, 1, 1] - 0.7) < 1e-6


def test_average_precision_hand_cases():
    assert average_precision(np.array([0.9, 0.8]), np.array([1, 1]), 2) == 1.0
    ap = average_precision(np.array([0.9, 0.8]), np.array([1, 0]), 2)
    assert abs(ap - 0.5) < 1e-6
    assert average_precision(np.zeros(0), np.zeros(0), 0) == 0.0


def test_map_streaming():
    m = MeanAveragePrecision(num_classes=3)
    gt = np.array([[[1, 0.1, 0.1, 0.4, 0.4],
                    [2, 0.5, 0.5, 0.8, 0.8]]], np.float32)
    det = np.array([[[1, 0.9, 0.1, 0.1, 0.4, 0.4],
                     [2, 0.8, 0.52, 0.52, 0.8, 0.8],
                     [1, 0.7, 0.6, 0.1, 0.9, 0.3],
                     [-1, 0, 0, 0, 0, 0]]], np.float32)
    m.update(det, gt)
    mean, aps = m.result()
    assert aps["1"] == 1.0 and aps["2"] == 1.0 and mean == 1.0
    m2 = MeanAveragePrecision(num_classes=2)
    det2 = np.array([[[1, 0.9, 0.1, 0.1, 0.4, 0.4],
                      [1, 0.8, 0.1, 0.1, 0.4, 0.4]]], np.float32)
    m2.update(det2, np.array([[[1, 0.1, 0.1, 0.4, 0.4]]], np.float32))
    assert m2.result()[1]["1"] == 1.0


def test_priors_structure():
    pb = PriorBox(min_size=30, max_size=60, aspect_ratios=(2.0,))
    assert pb.num_priors == 4
    pri = pb.generate(4, 4, 128.0)
    assert pri.shape == (4 * 4 * 4, 4)
    c = 0.5 * 32.0 / 128.0
    np.testing.assert_allclose(pri[0], [c - 30 / 256, c - 30 / 256,
                                        c + 30 / 256, c + 30 / 256],
                               atol=1e-6)
    stacked = ssd_priors([(4, 4), (2, 2)],
                         [pb, PriorBox(60, 90, aspect_ratios=(2.0,))], 128.0)
    assert stacked.shape == (64 + 16, 4)


def test_tiny_ssd_learns_synthetic_square():
    """End-to-end: images with one bright square; the SSD loss must drop
    and detection must localize the square (the JAX test's setting)."""
    rng = np.random.default_rng(6)
    n, res = 64, 64
    images = rng.normal(0, 0.05, size=(n, res, res, 3)).astype(np.float32)
    gt = np.full((n, 3, 5), -1.0, np.float32)
    for i in range(n):
        size = int(rng.integers(14, 26))
        x0 = int(rng.integers(0, res - size))
        y0 = int(rng.integers(0, res - size))
        images[i, y0:y0 + size, x0:x0 + size, :] = 1.0
        gt[i, 0] = [1, x0 / res, y0 / res, (x0 + size) / res,
                    (y0 + size) / res]
    det_model = ObjectDetector("ssd-lite", num_classes=2, resolution=res,
                               device="cpu").init_weights()
    det_model.compile(optimizer="adam", loss=det_model.multibox_loss(),
                      lr=3e-3)
    h = det_model.fit(images, gt, batch_size=16, nb_epoch=30)
    assert h["loss"][-1] < h["loss"][0] * 0.5, h["loss"]
    dets = det_model.detect(images[:8], conf_thresh=0.3)
    assert dets.shape[0] == 8 and dets.shape[2] == 6
    hits = 0
    for i in range(8):
        top = dets[i, 0]
        if top[0] == 1:
            hits += _naive_iou(top[None, 2:6], gt[i, :1, 1:5])[0, 0] > 0.3
    assert hits >= 5, f"only {hits}/8 detections localized the square"


def test_object_detector_save_load(tmp_path):
    rng = np.random.default_rng(7)
    det_model = ObjectDetector("ssd-lite", num_classes=2, resolution=64,
                               device="cpu").init_weights()
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    back = load_model(det_model.save(str(tmp_path / "ssd")), device="cpu")
    assert isinstance(back, ObjectDetector)
    np.testing.assert_allclose(det_model.predict(x), back.predict(x),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the port against the JAX functions
# ---------------------------------------------------------------------------

def test_priors_equal_jax():
    """SSD300's 8732 priors and ``ssd-lite``'s, the copy against the JAX
    module's, bit for bit."""
    jd = JDetector("ssd-vgg16-300", num_classes=21)
    peng.reset_uids()
    net, got = ssd_vgg(21, device="meta")
    assert got.shape == (8732, 4)
    np.testing.assert_array_equal(got, jd.priors)
    specs = [jpriors.PriorBox(12.8, 25.6), jpriors.PriorBox(32, 51.2)]
    mine = [PriorBox(12.8, 25.6), PriorBox(32, 51.2)]
    np.testing.assert_array_equal(
        ssd_priors([(8, 8), (4, 4)], mine, 64.0),
        jpriors.ssd_priors([(8, 8), (4, 4)], specs, 64.0))


def _nms_boxes(seed, rows, k):
    rng = np.random.default_rng(seed)
    boxes = np.stack([_rand_boxes(rng, k) for _ in range(rows)])
    # an IoU exactly at the threshold (0.5: inter 0.5, union 1), and the
    # same box twice (IoU 1), as tied scores put it
    boxes[0, 0] = [0.0, 0.0, 0.5, 1.0]
    boxes[0, 1] = [0.0, 0.0, 1.0, 1.0]
    boxes[0, 2] = [0.9, 0.0, 1.0, 0.05]
    boxes[0, 3] = boxes[0, 4] = [0.25, 0.25, 0.75, 0.75]
    return boxes


@pytest.mark.parametrize("threshold", [0.5, 0.45, 0.3])
def test_nms_plain_version_is_jax_bit_for_bit(threshold):
    """N1's plain version against the JAX ``nms_mask`` on every row (the
    IoU of 0.5 exactly at threshold 0.5 keeps its box, as ``>`` does);
    the IoUs themselves within 1e-6 of JAX's; the wrapper takes the plain
    version for CPU tensors."""
    boxes = _nms_boxes(int(threshold * 100), 5, 48)
    got = pnms.nms_keep_mask_reference(_t(boxes), threshold).numpy()
    want = np.asarray(jax.vmap(lambda b: jbbox.nms_mask(b, threshold))(
        jnp.asarray(boxes)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(nms_mask(boxes, threshold).numpy(), want)
    if threshold == 0.5:
        assert got[0, 1]                  # 0.5 is not above 0.5
        assert got[0, 3] and not got[0, 4]   # the duplicate is
    np.testing.assert_allclose(
        bbox_iou(boxes[0], boxes[0]).numpy(),
        np.asarray(jbbox.bbox_iou(boxes[0], boxes[0])), rtol=0, atol=1e-6)


def _fl32_sign(x):
    """The sign of ``x`` (a ``Fraction``) rounded once to f32, nearest
    even: 0 within 2^-150 of zero, where the rounding gives a zero."""
    tiny = Fraction(1, 2 ** 150)
    return 1 if x > tiny else -1 if x < -tiny else 0


def _n1_over_model(inter, uni, t):
    """N1's ``iou > t`` (``csrc/nms.cu`` ``test_pair``, then
    ``over_exact`` for the open pairs), its FMAs modelled exactly: each
    rounds the exact ``inter - c * uni`` once, so only its sign after that
    rounding is read."""
    t = np.float32(t)
    tp = np.nextafter(t, np.float32(np.inf))
    i, u = Fraction(float(inter)), Fraction(float(uni))
    if _fl32_sign(i - Fraction(float(tp)) * u) > 0:
        return True
    if _fl32_sign(i - Fraction(float(t)) * u) < 0:
        return False
    q = np.float32(inter) / np.float32(uni) if uni > 0 else np.float32(0)
    return bool(q > t)


def _plain_over(inter, uni, t):
    """The plain version's test: ``where(union > 0, inter / union, 0) >
    t`` in f32."""
    q = np.float32(inter) / np.float32(uni) if uni > 0 else np.float32(0)
    return bool(q > np.float32(t))


@pytest.mark.parametrize("threshold", [0.0, 0.3, 0.45, 0.5, 0.7])
def test_n1_division_free_test_is_the_division(threshold):
    """N1 decides ``iou > t`` without the division wherever the sign of an
    FMA settles it; a model of that predicate gives the division's answer
    on random pairs of real boxes, on quotients one to three ulps either
    side of every rounding cut near ``t`` and exactly on ``t``, on a zero
    union and on pairs that do not intersect. It is claimed where boxes
    take it, union >= inter >= 0 (what finite boxes give, held below on
    degenerate, inverted and touching boxes too): a negative union never
    reaches it."""
    t = np.float32(threshold)
    rng = np.random.default_rng(int(threshold * 100))
    pairs = []
    # random boxes, through the plain version's own f32 operations
    a, b = _rand_boxes(rng, 300), _rand_boxes(rng, 300)
    zero = np.float32(0)
    iw = np.maximum(np.minimum(a[:, 2], b[:, 2])
                    - np.maximum(a[:, 0], b[:, 0]), zero)
    ih = np.maximum(np.minimum(a[:, 3], b[:, 3])
                    - np.maximum(a[:, 1], b[:, 1]), zero)
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    pairs += list(zip(inter, (area_a + area_b) - inter))
    assert (inter == 0).sum() > 10          # pairs that do not intersect
    # quotients at the cut: inter near t * uni, a few ulps each way
    for uni in rng.uniform(0.01, 2.0, 40).astype(np.float32).tolist() + [
            0.5, 1.0, 0.25]:
        u = np.float32(uni)
        c = np.float32(t * u)
        for steps in range(-3, 4):
            v = c
            for _ in range(abs(steps)):
                v = np.nextafter(v, np.float32(np.inf if steps > 0
                                               else -np.inf))
            if v >= 0:
                pairs.append((v, u))
    # exactly on t (a power-of-two union), a zero union
    pairs += [(np.float32(t * np.float32(0.5)), np.float32(0.5)),
              (np.float32(0), np.float32(0)), (np.float32(0), np.float32(0.3))]
    cases = [(np.float32(i), np.float32(u)) for i, u in pairs]
    got = [_n1_over_model(i, u, t) for i, u in cases]
    want = [_plain_over(i, u, t) for i, u in cases]
    assert got == want
    # the cut is crossed: both answers occur near it
    assert any(got) and not all(got)
    # the domain: the plain version's f32 operations on any finite boxes,
    # degenerate (zero width), inverted (x2 < x1) and touching ones too
    # (which the clamps make zero width), give union >= inter >= 0
    box = rng.uniform(-1, 2, (4000, 2, 4)).astype(np.float32)
    box[:500, :, 2] = box[:500, :, 0]            # both zero width
    box[500:1000, 1, 0] = box[500:1000, 0, 2]    # b starts where a ends
    a, b = box[:, 0], box[:, 1]
    iw = np.maximum(np.minimum(a[:, 2], b[:, 2])
                    - np.maximum(a[:, 0], b[:, 0]), zero)
    ih = np.maximum(np.minimum(a[:, 3], b[:, 3])
                    - np.maximum(a[:, 1], b[:, 1]), zero)
    inter = iw * ih
    area_a = (np.maximum(a[:, 2] - a[:, 0], zero)
              * np.maximum(a[:, 3] - a[:, 1], zero))
    area_b = (np.maximum(b[:, 2] - b[:, 0], zero)
              * np.maximum(b[:, 3] - b[:, 1], zero))
    uni = (area_a + area_b) - inter
    assert (inter >= 0).all() and (uni >= inter).all()
    assert (inter == 0).any() and (uni == 0).any()
    assert not _n1_over_model(np.float32(t * np.float32(0.5)),
                              np.float32(0.5), t)   # on t: not above it


def test_nms_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        pnms.nms_keep_mask(torch.zeros(4, 3))


def _detection_inputs(seed, b=3, p=120, c=4, ties=True):
    rng = np.random.default_rng(seed)
    priors = _rand_boxes(rng, p)
    loc = rng.normal(0, 0.5, size=(b, p, 4)).astype(np.float32)
    logits = rng.normal(0, 2, size=(b, p, c)).astype(np.float32)
    if ties:
        # whole rows of equal scores: below conf_thresh they are all 0
        logits[:, ::3] = 0.0
    conf = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    return loc, conf, priors


@pytest.mark.parametrize("kw", [
    dict(conf_thresh=0.01, nms_topk=400, keep_topk=200),
    dict(conf_thresh=0.3, nms_topk=50, keep_topk=40),
    dict(conf_thresh=0.9, nms_topk=20, keep_topk=600, bg_label=2),
], ids=["defaults", "cut_topk", "sparse_padded"])
def test_detection_output_matches_jax(kw):
    """The same probabilities through both: labels, scores' order (the
    stable top-k among tied scores, padding included) and scores equal,
    boxes within 1e-6."""
    loc, conf, priors = _detection_inputs(sum(map(ord, str(kw))) % 1000)
    want = np.asarray(jbbox.batched_detection_output(
        loc, conf, priors, num_classes=4, **kw))
    got = batched_detection_output(loc, conf, priors, num_classes=4,
                                   **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0,
                               atol=1e-6)


def test_match_priors_matches_jax_with_a_shared_best_prior():
    """Random gts, then two gts whose best prior is the same: the JAX
    scatter's winner (the later gt) is the port's."""
    rng = np.random.default_rng(9)
    priors = _rand_boxes(rng, 60)
    gt = np.full((5, 5), -1.0, np.float32)
    gt[:3, 0] = [1, 2, 1]
    gt[:3, 1:] = _rand_boxes(rng, 3)
    gt[3] = [2, *(priors[11] + [0.01, 0.0, 0.01, 0.0])]
    gt[1] = [1, *(priors[11] + [0.0, 0.01, 0.0, 0.01])]
    wi, wp = map(np.asarray, jmbl.match_priors(gt, priors, 0.5))
    gi, gp = (t.numpy() for t in match_priors(gt, priors, 0.5))
    best = np.argmax(_naive_iou(priors, gt[[1, 3], 1:5]), axis=0)
    assert best[0] == best[1] == 11
    assert wi[11] == 3       # the later gt wins in the JAX scatter
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gi, wi)


def _loss_inputs(seed=12, n=4):
    rng = np.random.default_rng(seed)
    images, gt = _square_images(rng, n, RES)
    # a second object in half the images, and one shared with another
    gt[::2, 1] = [2, 0.1, 0.1, 0.35, 0.4]
    return images, gt


def test_forward_loss_and_gradients_match_jax():
    """``ssd-lite``'s forward, MultiBoxLoss and its gradient on every
    parameter, with the discrete choices (matching and mining) equal."""
    jd, pd, _ = _pair()
    images, gt = _loss_inputs()
    jloss, ploss = jd.multibox_loss(), pd.multibox_loss()

    def jfn(params):
        y, _ = jd.model.apply(params, jd.net_state, jnp.asarray(images),
                              training=False)
        return jloss(jnp.asarray(gt), y), y

    (jl, jy), jg = jax.value_and_grad(jfn, has_aux=True)(jd.params)
    y = pd.model(_t(images), training=False)
    loss = ploss(_t(gt), y)
    loss.backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=RTOL, atol=ATOL)
    # matching and mining: the same priors chosen
    for b in range(len(gt)):
        wi, wp = map(np.asarray, jmbl.match_priors(gt[b], jd.priors, 0.5))
        gi, gp = (t.numpy() for t in match_priors(gt[b], pd.priors, 0.5))
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gi[wp], wi[wp])
    grads = {n: p.grad.numpy() for n, p in pd.model.named_parameters()}
    flat = _tree(jg)
    for name, g in grads.items():
        layer, leaf = name.split(".")
        np.testing.assert_allclose(g, flat[layer][leaf], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def _jax_negatives(ce, pos, ratio=3.0):
    """The JAX loss's mining, its own expression (``multibox_loss.py``)."""
    neg_ce = jnp.where(pos, -jnp.inf, ce)
    order = jnp.argsort(-neg_ce)
    rank = jnp.argsort(order)
    n_neg = jnp.minimum(ratio * jnp.sum(pos.astype(jnp.float32)),
                        jnp.sum(~pos).astype(jnp.float32))
    return (rank < n_neg) & ~pos


def test_hard_negatives_match_jax_with_ties():
    rng = np.random.default_rng(13)
    ce = rng.normal(size=(3, 90)).astype(np.float32)
    ce[:, ::4] = 1.0                       # ties across the cut
    pos = rng.random((3, 90)) < 0.1
    got = hard_negatives(_t(ce), _t(pos)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.vmap(_jax_negatives)(jnp.asarray(ce),
                                                 jnp.asarray(pos))))


def test_two_epoch_fit_matches_jax():
    """A 2-epoch Adam fit of ``ssd-lite`` from the same weights on the same
    batches (``shuffle=False``): first the discrete choices on the data
    (matching, mining on the initial logits, NMS of the initial
    detections) equal, then the epoch losses and the trained parameters,
    and the trained detectors' tables."""
    jd, pd, _ = _pair()
    images, gt = _square_images(np.random.default_rng(14), 16, RES)
    y0 = pd.model(_t(images), training=False).detach()
    jy0 = np.asarray(jd.model.apply(jd.params, jd.net_state,
                                    jnp.asarray(images))[0])
    gi, gp = (t.numpy() for t in match_priors(gt[0], pd.priors, 0.5))
    wi, wp = map(np.asarray, jmbl.match_priors(gt[0], jd.priors, 0.5))
    np.testing.assert_array_equal(gp, wp)
    import analytics_zoo_tpu_torch.models.image.objectdetection.multibox_loss \
        as pmbl
    pidx, ppos = pmbl._match(_t(gt), _t(pd.priors), 0.5)
    logp = torch.log_softmax(y0[..., 4:], -1)
    labels = torch.where(ppos, torch.gather(_t(gt), 1, pidx[..., None]
                                            .expand(-1, -1, 5))[..., 0]
                         .long(), torch.zeros_like(pidx))
    ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
    neg = hard_negatives(ce, ppos).numpy()
    # the JAX loss's own CE expression on the JAX forward's logits
    jlogp = jax.nn.log_softmax(jnp.asarray(jy0[..., 4:]), -1)  # zoolint: disable=ZL012 3-class head; the CE is what the mining ranks
    jce = -jnp.take_along_axis(
        jlogp, jnp.asarray(labels.numpy())[..., None], -1)[..., 0]
    np.testing.assert_array_equal(
        neg, np.asarray(jax.vmap(_jax_negatives)(
            jce, jnp.asarray(ppos.numpy()))))
    np.testing.assert_array_equal(
        pd.detect(images[:4], conf_thresh=0.0)[..., 0],
        jd.detect(images[:4], conf_thresh=0.0)[..., 0])

    jd.compile(optimizer="adam", loss=jd.multibox_loss(), lr=1e-3)
    pd.compile(optimizer="adam", loss=pd.multibox_loss(), lr=1e-3)
    jh = jd.fit(images, gt, batch_size=8, nb_epoch=2, shuffle=False)
    ph = pd.fit(images, gt, batch_size=8, nb_epoch=2, shuffle=False)
    np.testing.assert_allclose(ph["loss"], jh["loss"], rtol=FIT_RTOL,
                               atol=FIT_ATOL)
    got = _param_tree(dict(pd.model.named_parameters()))
    want = _tree(jd.params)
    for layer, leaves in got.items():
        for leaf, v in leaves.items():
            np.testing.assert_allclose(v.detach().numpy(),
                                       want[layer][leaf], rtol=FIT_RTOL,
                                       atol=FIT_ATOL, err_msg=layer)


def test_static_int8_matches_jax_quantized_call():
    """``ssd-lite`` on static int8: the same calibrated layers and scales,
    the same int8 weights, and each conv's C8 plain version bit for bit
    the JAX ``quantized_call`` (the int32 product and its f32 epilogue) on
    the same input; the predicts within 1e-4."""
    from analytics_zoo_tpu.pipeline.api.keras import layers as jl
    jd, pd, _ = _pair()
    images, _ = _square_images(np.random.default_rng(15), 8, RES)
    jax_im = JaxIM().from_keras(jd.model, quantize="int8",
                                calibrate=images[:4])
    im = InferenceModel(device="cpu").from_keras(pd.model, quantize="int8",
                                                 calibrate=images[:4])
    names = {"c1", "c2", "c3", "c4", "mbox0_loc", "mbox0_conf",
             "mbox1_loc", "mbox1_conf"}
    assert set(im._act_scales) == set(jax_im._act_scales) == names
    rng = np.random.default_rng(16)
    for name in sorted(names):
        scale, shape = jax_im._act_scales[name]
        assert im._act_scales[name][1] == shape
        np.testing.assert_allclose(im._act_scales[name][0], scale,
                                   rtol=1e-6, atol=0)
        mine = getattr(im._model, name)
        jp = jax_im._params[name]
        np.testing.assert_array_equal(mine.W.numpy(), np.asarray(jp["W"]))
        x = rng.normal(size=(2, 8, 8, shape[2])).astype(np.float32)
        jlayer = jl.Convolution2D(shape[3], shape[0], shape[1],
                                  subsample=mine.subsample,
                                  border_mode="same",
                                  activation=("relu" if name[0] == "c"
                                              else None))
        want = np.asarray(jlayer.quantized_call(jp, jnp.asarray(x)))  # zoolint: disable=ZL009 each layer's own input, once
        # JAX's x_scale: the two calibrations' agree to an ulp (each
        # layer's input max comes through the other's float forward)
        got = pq.static_int8_conv2d(
            _t(x), _t(np.asarray(jp["x_scale"])), mine.W, mine.w_scale,
            mine.b, name[0] == "c", mine.subsample, mine.dilation,
            mine._pads(_t(x)))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    np.testing.assert_allclose(im.predict(images),
                               np.asarray(jax_im.predict(images)),
                               rtol=0, atol=1e-4)


def test_npz_loads_across_packages(tmp_path):
    """The JAX detector's ``.npz`` loads into the port and the port's into
    JAX, with the config (post_param included) and the same predictions."""
    from analytics_zoo_tpu.models.common.zoo_model import \
        load_model as jload
    jd, pd, x = _pair()
    jd.post_param.nms_topk = 123
    back = load_model(jd.save(str(tmp_path / "jax")), device="cpu")
    assert isinstance(back, ObjectDetector)
    assert back.post_param == DetectionOutputParam(nms_topk=123)
    np.testing.assert_allclose(back.predict(x), np.asarray(jd.predict(x)),
                               rtol=RTOL, atol=ATOL)
    pd.post_param.keep_topk = 77
    jback = jload(pd.save(str(tmp_path / "port")))
    # JAX's load_model hands a saved post_param back as the dict it was
    pp = jback.post_param
    assert (pp if isinstance(pp, dict) else vars(pp))["keep_topk"] == 77
    np.testing.assert_allclose(np.asarray(jback.predict(x)), pd.predict(x),
                               rtol=RTOL, atol=ATOL)


def test_decode_takes_a_flat_row_and_keeps_the_device():
    jd, pd, x = _pair()
    raw = pd.predict(x)
    np.testing.assert_array_equal(pd.decode(raw[0]), pd.decode(raw)[:1])
    np.testing.assert_array_equal(pd.decode(raw), pd.detect(x))
    np.testing.assert_array_equal(pd.decode(raw)[..., 0],
                                  jd.decode(raw)[..., 0])


def test_ssd300_builds_under_the_jax_names():
    """SSD300-VGG16's graph: the JAX layer names and parameter shapes (on
    the meta device, no weights drawn), 35 convs, 8732 priors."""
    jd = JDetector("ssd-vgg16-300", num_classes=21)
    want = {k: v for k, v in jax.eval_shape(lambda: jd.model.build(
        jax.random.key(0), (None, 300, 300, 3))).items() if v}
    peng.reset_uids()
    net, _ = ssd_vgg(21, device="meta")
    net.build(generator=torch.Generator())
    got = _param_tree({n: p for n, p in net.named_parameters()})
    assert set(got) == set(want)
    for layer, leaves in got.items():
        assert {k: tuple(v.shape) for k, v in leaves.items()} == {
            k: tuple(v.shape) for k, v in want[layer].items()}, layer
    from analytics_zoo_tpu_torch.pipeline.api.keras.layers import \
        Convolution2D
    assert sum(isinstance(m, Convolution2D) for m in net.modules()) == 35


def test_objectdetection_imports_no_jax():
    """Importing the package and running a detect, a loss step and a
    static int8 predict leaves jax and the JAX package out of
    ``sys.modules``."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, numpy as np, torch\n"
        "from analytics_zoo_tpu_torch.models.image.objectdetection import "
        "ObjectDetector\n"
        "from analytics_zoo_tpu_torch.pipeline.inference import "
        "InferenceModel\n"
        "d = ObjectDetector('ssd-lite', 2, 32, device='cpu').init_weights()\n"
        "x = np.ones((2, 32, 32, 3), np.float32)\n"
        "d.detect(x)\n"
        "gt = np.array([[[1, .1, .1, .5, .5]]] * 2, np.float32)\n"
        "d.multibox_loss()(torch.from_numpy(gt), d(torch.from_numpy(x)))"
        ".backward()\n"
        "InferenceModel(device='cpu').from_keras(d.model, quantize='int8', "
        "calibrate=x).predict(x)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'analytics_zoo_tpu' or "
        "n.startswith('analytics_zoo_tpu.'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = repo
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_ssd300_forward_on_the_jax_weights_matches_jax():
    """SSD300-VGG16 at full width (21 classes, 300 x 300) on the JAX
    detector's weights, carried across by name (the convs, the atrous
    fc6, ``conv4_3_scale`` and every loc and conf head): the fused (1,
    8732, 25) output within 1e-4 of the largest value, and the decoded
    table's labels the JAX decode's."""
    x = np.random.default_rng(17).normal(size=(1, 300, 300, 3)).astype(
        np.float32)
    jd = JDetector("ssd-vgg16-300", num_classes=21)
    jd.init_weights(sample_input=x)
    pd = ObjectDetector("ssd-vgg16-300", num_classes=21, device="cpu")
    pd.load_jax_params(_tree(jd.params))
    np.testing.assert_array_equal(
        pd.model.conv4_3_scale.weight.detach().numpy(),
        np.asarray(jd.params["conv4_3_scale"]["weight"]))
    want = np.asarray(jd.predict(x))
    got = pd.predict(x)
    assert got.shape == want.shape == (1, 8732, 25)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(pd.decode(want)[..., 0],
                                  jd.decode(want)[..., 0])
