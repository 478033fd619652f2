"""The port's data layer equals the JAX package's on files the test writes.

Calib text and files, PNG reading and writing through the native decoder
and through PIL, the native PFM codec, a MiddEval3-shaped tree (indices,
images, intrinsics, ndisp, GT and masks, ``load_batch``,
``downsample_pair``), the HitNet loaders, ``StageStore``, the per-pair
failure-masking runner and the profiling helpers. Every comparison is
exact (``array_equal`` / ``==``): these are host copies of NumPy code.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu.data import hitnet as jhitnet
from stereo_reconstruction_tpu.data import middeval3 as jmid
from stereo_reconstruction_tpu.io import calib as jcalib
from stereo_reconstruction_tpu.io import image as jimage
from stereo_reconstruction_tpu.io import native as jnative
from stereo_reconstruction_tpu.utils import batch as jbatch
from stereo_reconstruction_tpu.utils import staging as jstaging
from stereo_reconstruction_tpu_torch.data import hitnet as thitnet
from stereo_reconstruction_tpu_torch.data import middeval3 as tmid
from stereo_reconstruction_tpu_torch.io import calib as tcalib
from stereo_reconstruction_tpu_torch.io import image as timage
from stereo_reconstruction_tpu_torch.io import native as tnative
from stereo_reconstruction_tpu_torch.utils import batch as tbatch
from stereo_reconstruction_tpu_torch.utils import profiling as tprof
from stereo_reconstruction_tpu_torch.utils import staging as tstaging

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import write_middeval_scene, write_png  # noqa: E402

torch.set_num_threads(1)

CALIB_TEXT = """cam0=[1758.23 0 953.34; 0 1758.23 552.29; 0 0 1]
cam1=[1758.23 0 953.34; 0 1758.23 552.29; 0 0 1]
doffs=0
baseline=97.99
width=1920
height=1080
ndisp=290
isint=0
vmin=75
vmax=262
"""

PAIR_FIELDS = ("image_left", "image_right", "intrinsics_left", "intrinsics_right",
               "disp_left_gt", "disp_right_gt", "mask_left_nocc", "mask_right_nocc")


def _same_calib(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), f.name
        else:
            assert g == w, f.name


def _same_pair(got, want):
    for f in PAIR_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert (got.name, got.ndisp, got.height, got.width) == (
        want.name, want.ndisp, want.height, want.width)


def test_parse_calib_text_equals_jax():
    _same_calib(tcalib.parse_calib(CALIB_TEXT), jcalib.parse_calib(CALIB_TEXT))


def test_parse_calib_file_equals_jax(tmp_path):
    path = tmp_path / "calib.txt"
    path.write_text(CALIB_TEXT)
    got = tcalib.parse_calib(str(path))
    _same_calib(got, jcalib.parse_calib(str(path)))
    assert got.ndisp == 290 and got.cam1[0, 2] == np.float32(953.34)


def test_parse_calib_rejects_a_missing_camera():
    for parse in (jcalib.parse_calib, tcalib.parse_calib):
        with pytest.raises(ValueError, match="cam0 and cam1"):
            parse("cam0=[1 0 0; 0 1 0; 0 0 1]\nndisp=4\n")


@pytest.mark.parametrize("shape", [(23, 31, 3), (17, 29)])
def test_write_image_byte_identical(tmp_path, rng, shape):
    img = rng.integers(0, 256, shape).astype(np.uint8)
    jimage.write_image(str(tmp_path / "j.png"), img)
    timage.write_image(str(tmp_path / "t.png"), img)
    assert (tmp_path / "j.png").read_bytes() == (tmp_path / "t.png").read_bytes()
    # float input: rounded and clipped the same way
    f = rng.uniform(-20, 280, shape)
    jimage.write_image(str(tmp_path / "jf.png"), f)
    timage.write_image(str(tmp_path / "tf.png"), f)
    assert (tmp_path / "jf.png").read_bytes() == (tmp_path / "tf.png").read_bytes()


@pytest.fixture()
def png(tmp_path, rng):
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    return path, img


@pytest.mark.parametrize("grayscale", [False, True])
def test_read_image_native_equals_jax(png, grayscale):
    path, img = png
    assert tnative.available(), tnative.build_error()
    got = timage.read_image(path, grayscale=grayscale)
    want = jimage.read_image(path, grayscale=grayscale)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if not grayscale:
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("grayscale", [False, True])
def test_read_image_through_pil_equals_jax(png, monkeypatch, grayscale):
    path, img = png
    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "build_error", lambda: "disabled by the test")
    got = timage.read_image(path, grayscale=grayscale)
    monkeypatch.setattr(jnative, "available", lambda: False)
    want = jimage.read_image(path, grayscale=grayscale)
    np.testing.assert_array_equal(got, want)
    if not grayscale:
        np.testing.assert_array_equal(got, img)


def test_read_image_names_both_readers_when_neither_works(png, monkeypatch):
    path, _ = png
    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "build_error", lambda: "no g++ here")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="native decoder.*no g\\+\\+ here.*PIL"):
        timage.read_image(path)


def test_native_library_is_the_checkout_copy():
    assert tnative.LIB_PATH == tnative.NATIVE_DIR / "libstereo_io.so"
    assert tnative.NATIVE_DIR.parent.joinpath("stereo_reconstruction_tpu_torch").is_dir()


def test_native_pfm_and_png_batch_equal_jax(tmp_path, rng):
    x = rng.standard_normal((19, 23)).astype(np.float32)
    tnative.write_pfm(str(tmp_path / "t.pfm"), x)
    jnative.write_pfm(str(tmp_path / "j.pfm"), x)
    assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
    np.testing.assert_array_equal(tnative.read_pfm(str(tmp_path / "j.pfm")), x)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"{i}.png"))
        write_png(paths[-1], rng.integers(0, 256, (9, 14, 3)).astype(np.uint8))
    np.testing.assert_array_equal(tnative.read_png_batch(paths, 9, 14),
                                  jnative.read_png_batch(paths, 9, 14))


def _scene_arrays(rng, h, w, with_gt):
    left = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    right = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    K = np.array([[float(w), 0, w / 2], [0, float(w), h / 2], [0, 0, 1]])
    kw = {}
    if with_gt:
        gt = rng.uniform(0, 30, (h, w)).astype(np.float32)
        gt[rng.uniform(size=(h, w)) < 0.1] = np.inf
        kw = dict(gt=gt, mask=np.where(rng.uniform(size=(h, w)) < 0.8, 255, 0),
                  gt_left=gt[:, ::-1].copy())
    return left, right, K, kw


@pytest.fixture()
def tree(tmp_path, rng):
    """trainingH: "Beta" 30x46 with right GT, both-side GT minus the left
    mask; "Alpha" 28x40 with no GT; testH: "Gamma" 26x38."""
    root = str(tmp_path / "MiddEval3")
    for name, h, w, gt in (("Beta", 30, 46, True), ("Alpha", 28, 40, False)):
        left, right, K, kw = _scene_arrays(rng, h, w, gt)
        write_middeval_scene(root, name, left, right, K, ndisp=32, **kw)
    left, right, K, _ = _scene_arrays(rng, 26, 38, False)
    write_middeval_scene(root, "Gamma", left, right, K, ndisp=24, split="testH")
    return root


def test_middeval3_index_and_loads_equal_jax(tree):
    t, j = tmid.MiddEval3(tree), jmid.MiddEval3(tree)
    assert t.training_names() == j.training_names() == ["Alpha", "Beta"]
    assert (t.num_training, t.num_test) == (j.num_training, j.num_test) == (2, 1)
    for i in range(2):
        _same_pair(t.load_training(i), j.load_training(i))
    _same_pair(t.load_test(0), j.load_test(0))
    beta = t.load_training(1)
    assert beta.disp_right_gt is not None and beta.mask_left_nocc is None
    assert t.load_training(0).disp_right_gt is None
    assert tmid.EVAL_SCENARIOS == jmid.EVAL_SCENARIOS


def test_middeval3_load_batch_equals_jax(tree):
    t, j = tmid.MiddEval3(tree), jmid.MiddEval3(tree)
    for kw in ({}, dict(height=32, width=48)):
        got, want = t.load_batch([0, 1], **kw), j.load_batch([0, 1], **kw)
        for g, w in zip(got, want):
            _same_pair(g, w)
    _same_pair(t.load_batch([0], split="test")[0], j.load_batch([0], split="test")[0])


def test_attach_gt_skips_an_unreadable_pfm(tree):
    d = os.path.join(tree, "trainingH", "Alpha")
    with open(os.path.join(d, "disp1GT.pfm"), "w") as f:
        f.write("not a pfm")
    t = tmid.MiddEval3(tree).load_training(0)
    j = jmid.MiddEval3(tree).load_training(0)
    assert t.disp_right_gt is None and j.disp_right_gt is None


@pytest.mark.parametrize("factor", [2, 3])
def test_downsample_pair_equals_jax(tree, factor):
    t = tmid.downsample_pair(tmid.MiddEval3(tree).load_training(1), factor)
    j = jmid.downsample_pair(jmid.MiddEval3(tree).load_training(1), factor)
    _same_pair(t, j)
    _same_pair(tmid.downsample_pair(t), jmid.downsample_pair(j))


def _hitnet_tree(root, scenes):
    for split, name, value in scenes:
        d = os.path.join(root, split, name)
        os.makedirs(d)
        img = np.full((8, 10), value, np.uint8)
        img[2:4, 3:7] = value + 7
        write_png(os.path.join(d, "im0_reference.png"),
                  np.repeat(img[..., None], 3, axis=2))


def test_hitnet_loaders_equal_jax(tmp_path):
    root = str(tmp_path)
    _hitnet_tree(root, [("trainingH", "Zebra", 30), ("trainingH", "Adirondack", 10),
                        ("testH", "OnlyOne", 40)])
    t, j = thitnet.PrecomputedDisparities(root), jhitnet.PrecomputedDisparities(root)
    assert t.training_paths == j.training_paths and t.test_paths == j.test_paths
    for i in range(2):
        g, w = t.load_training(i), j.load_training(i)
        assert g.dtype == w.dtype and np.array_equal(g, w)
    np.testing.assert_array_equal(t.load_test(0), j.load_test(0))
    path = os.path.join(root, "trainingH", "Zebra", "im0_reference.png")
    np.testing.assert_array_equal(thitnet.read_grayscale_disparity(path),
                                  jhitnet.read_grayscale_disparity(path))
    scene = os.path.dirname(path)
    np.testing.assert_array_equal(thitnet.read_hitnet_disparity(scene),
                                  jhitnet.read_hitnet_disparity(scene))


@pytest.mark.parametrize("case", ["plain", "inf", "negative", "zero_mean", "all_inf"])
def test_rescale_to_gt_mean_equals_jax(rng, case):
    disp = rng.uniform(1, 40, (12, 15)).astype(np.float32)
    gt = rng.uniform(1, 60, (12, 15)).astype(np.float32)
    if case == "inf":
        gt[rng.uniform(size=gt.shape) < 0.3] = np.inf
        disp[0, :4] = -np.inf
    elif case == "negative":
        disp -= 30
    elif case == "zero_mean":
        disp[:] = 0
    elif case == "all_inf":
        gt[:] = np.inf
    got = thitnet.rescale_to_gt_mean(disp, gt)
    want = jhitnet.rescale_to_gt_mean(disp, gt)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    a, b = thitnet.average_disparity(disp), jhitnet.average_disparity(disp)
    assert (np.isnan(a) and np.isnan(b)) or a == b


def test_stage_store_round_trips_and_reads_jax_stages(tmp_path, rng):
    arr = rng.standard_normal((7, 9)).astype(np.float32)
    payload = {"pose": np.eye(4), "n": np.int64(3), "err": np.float32(0.5), "s": "x"}
    t = tstaging.StageStore(str(tmp_path / "t"), "scene")
    j = jstaging.StageStore(str(tmp_path / "j"), "scene")
    for store in (t, j):
        store.save_array("disparity", arr)
        store.save_json("pose", payload)
    assert (tmp_path / "t/scene/disparity.pfm").read_bytes() == (
        tmp_path / "j/scene/disparity.pfm").read_bytes()
    assert (tmp_path / "t/scene/pose.json").read_text() == (
        tmp_path / "j/scene/pose.json").read_text()
    np.testing.assert_array_equal(t.load_array("disparity"), arr)
    assert t.load_json("pose") == j.load_json("pose")
    calls = []
    got = t.resume_or_compute("disparity", lambda: calls.append(1))
    np.testing.assert_array_equal(got, arr)
    assert not calls and not t.has("depth")
    depth = t.resume_or_compute("depth", lambda: arr * 2)
    np.testing.assert_array_equal(t.load_array("depth"), depth)
    assert t.resume_or_compute("m", lambda: {"a": 1}, kind="json") == {"a": 1}
    assert t.resume_or_compute("m", lambda: {"a": 2}, kind="json") == {"a": 1}


@dataclasses.dataclass
class _FakePair:
    name: str


@dataclasses.dataclass
class _FakeResult:
    metrics: dict


def _fake_fn(pair):
    if pair.name == "boom":
        raise RuntimeError("synthetic per-pair failure")
    return _FakeResult(metrics={"bad_percent": 10.0 if pair.name == "a" else 20.0,
                                "name_len": len(pair.name)})


def test_batch_runner_masks_failures_like_jax(tmp_path):
    pairs = [_FakePair("a"), _FakePair("boom"), _FakePair("ccc")]
    got = tbatch.run_batch(pairs, _fake_fn, metrics_path=str(tmp_path / "t.jsonl"))
    want = jbatch.run_batch(pairs, _fake_fn, metrics_path=str(tmp_path / "j.jsonl"))
    assert [(o.name, o.ok, o.error) for o in got] == [(o.name, o.ok, o.error) for o in want]
    assert "RuntimeError" in got[1].error
    assert tbatch.aggregate_metrics(got) == jbatch.aggregate_metrics(want)
    assert tbatch.aggregate_metrics(got)["bad_percent"] == pytest.approx(15.0)

    def records(name):
        lines = (tmp_path / name).read_text().strip().splitlines()
        return [{k: v for k, v in json.loads(x).items() if k != "ts"} for x in lines]

    assert records("t.jsonl") == records("j.jsonl")
    assert len(records("t.jsonl")) == 3


def test_stage_timer_append_jsonl_and_profile(tmp_path):
    tprof.clear()
    timer = tprof.StageTimer()
    x = torch.arange(6.0)
    with timer.stage("a", x):
        y = x * 2
    with timer.stage("a"):
        pass
    import time

    timer.fence("b", {"y": [y, (y,)]}, time.perf_counter())
    assert set(timer.timings) == {"a", "b"} and all(v >= 0 for v in timer.timings.values())
    path = str(tmp_path / "m.jsonl")
    tprof.append_jsonl(path, {"t": torch.tensor([1.5, 2.0]), "n": np.int32(4),
                              "f": np.float32(0.25), "a": np.arange(2)})
    rec = json.loads(open(path).read())
    assert rec["t"] == [1.5, 2.0] and rec["n"] == 4 and rec["f"] == 0.25
    assert rec["a"] == [0, 1] and "ts" in rec
    # the stages are spans: recorded, and ranges of the profile, only
    # while a profiler session is active
    assert tprof.spans() == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("c", x):
            torch.ones(3).sum()
    assert [s.name for s in tprof.spans()] == ["c"] and tprof.dropped() == 0
    assert "c" in {e.name() for e in prof.profiler.kineto_results.events()}
    assert timer.timings["c"] >= 0
    tprof.clear()
