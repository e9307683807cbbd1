"""The port's input pipeline on the CPU against the JAX package's: the dataset
index, the batch order, the validation pass, the raw batches of the on-card
augmentation, the run directory's tables, and the port's own PNG reader.

Sources are written at the loader's imgsz, so that neither package resizes
(the JAX package resizes with cv2, the port with PyTorch's bilinear; their
pixels may differ by a level): everything is compared exactly. Where a
source is resized, the pixels are held within 2 levels and the labels and
letterbox parameters exactly."""

import sys
import struct
import zlib

import numpy as np
import pytest
import yaml

from deal_yolo_daya_tpu.train import artifacts as jax_artifacts
from deal_yolo_daya_tpu.train import data as jax_data
from deal_yolo_daya_tpu_torch.ops import letterbox as port_letterbox
from deal_yolo_daya_tpu_torch.ops.png import read_png, write_png
from deal_yolo_daya_tpu_torch.train import artifacts as port_artifacts
from deal_yolo_daya_tpu_torch.train import data as port_data
from tests.test_data import make_dataset
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

IMGSZ = 64


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("port_data"), n_train=10, n_val=5,
                        imgsz=IMGSZ, nc=3)


def _loaders(data_yaml, split, imgsz=IMGSZ, **kw):
    jds = jax_data.YoloDataset.from_yaml(str(data_yaml), split)
    pds = port_data.YoloDataset.from_yaml(str(data_yaml), split)
    return (jax_data.DataLoader(jds, 4, imgsz, seed=7, max_boxes=8, **kw),
            port_data.DataLoader(pds, 4, imgsz, seed=7, max_boxes=8, **kw))


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_from_yaml_matches_jax(data_yaml, split):
    j = jax_data.YoloDataset.from_yaml(str(data_yaml), split)
    p = port_data.YoloDataset.from_yaml(str(data_yaml), split)
    assert (p.root, p.names, p.images, p.nc) == (j.root, j.names, j.images, j.nc)
    assert len(p.labels) == len(j.labels)
    for i, (a, b) in enumerate(zip(p.labels, j.labels)):
        np.testing.assert_array_equal(a, b)
        for got, want in zip(p.boxes_xyxy(i, 80, 48), j.boxes_xyxy(i, 80, 48)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype


def test_names_as_a_map_and_relative_path(tmp_path):
    """datakit writes names as a list, synth_dataset as an int -> name map;
    a relative ``path`` resolves against the yaml's folder."""
    (tmp_path / "ds" / "images" / "train").mkdir(parents=True)
    data = tmp_path / "data.yaml"
    data.write_text(yaml.dump({"path": "ds", "train": "images/train",
                               "names": {1: "square", 0: "circle", 2: "triangle"}}))
    p = port_data.YoloDataset.from_yaml(str(data), "train")
    j = jax_data.YoloDataset.from_yaml(str(data), "train")
    assert p.names == j.names == ["circle", "square", "triangle"]
    assert p.root == j.root == (tmp_path / "ds").resolve()


@pytest.mark.parametrize("augment", [True, False])
def test_epoch_indices_match_jax(data_yaml, augment):
    jl, pl = _loaders(data_yaml, "train", augment=augment)
    assert len(pl) == len(jl)
    for epoch in range(3):
        want, got = list(jl.epoch_indices(epoch)), list(pl.epoch_indices(epoch))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("imgsz", [IMGSZ, 96])
def test_validation_epoch_matches_jax(data_yaml, imgsz):
    """The letterboxed pass of validation: order, padded labels and meta
    exactly; pixels exactly at imgsz and within 2 levels when resized."""
    jl, pl = _loaders(data_yaml, "val", imgsz, augment=False, keep_meta=True, shuffle=False,
                      drop_last=False)
    want, got = list(jl.epoch(0)), list(pl.epoch(0))
    assert len(got) == len(want) == 2  # 5 images, the last batch wrapped
    for g, w in zip(got, want):
        diff = np.abs(g.images.astype(int) - w.images.astype(int))
        assert diff.max() <= (0 if imgsz == IMGSZ else 2), diff.max()
        for k in ("gt_boxes", "gt_classes", "gt_mask"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
            assert getattr(g, k).dtype == getattr(w, k).dtype
        assert g.meta == w.meta


def test_raw_batches_match_jax(data_yaml):
    """load_raw, raw_chunks (the device cache's feed) and epoch_raw."""
    jl, pl = _loaders(data_yaml, "train", augment=True)
    for got, want in zip(pl.raw_chunks(chunk_size=4), jl.raw_chunks(chunk_size=4)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    for got, want in zip(pl.epoch_raw(1), jl.epoch_raw(1)):
        for k in ("images", "hw", "gt_boxes", "gt_classes", "gt_mask"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_pad_labels_matches_jax():
    rng = np.random.default_rng(0)
    for n in (0, 3, 8, 11):
        boxes = rng.uniform(0, 64, (n, 4)).astype(np.float32)
        classes = rng.integers(0, 5, n)
        for a, b in zip(port_data._pad_labels(boxes, classes, 8),
                        jax_data._pad_labels(boxes, classes, 8)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_prefetcher_keeps_order_and_raises_in_the_consumer():
    assert list(port_data.Prefetcher(iter(range(10)), depth=2, transfer=lambda x: x * x)) == \
        [i * i for i in range(10)]

    def broken():
        yield 1
        raise OSError("disk gone")

    items = port_data.Prefetcher(broken(), depth=2)
    with pytest.raises(OSError, match="disk gone"):
        list(items)


# ---------------------------------------------------------------- the run directory


def test_args_yaml_and_results_csv_match_jax(tmp_path):
    """The same args and rows give the same bytes; args.yaml reads back."""
    args = {"model": "yolo11n", "data": tmp_path / "data.yaml", "imgsz": 640, "lr0": 0.01,
            "resume": False, "cache": None, "names": ["a", "名"], "extra": {"k": 1}}
    rows = [{"epoch": e, "time": 1.5 * e, "train/box_loss": 1.0 / (e + 2),
             "metrics/mAP50(B)": 0.25, "lr/pg2": 1e-6} for e in (1, 2)]
    paths = []
    for mod in (port_artifacts, jax_artifacts):
        run = mod.RunDir(str(tmp_path / mod.__name__.split(".")[0]), "train")
        run.write_args(args)
        for r in rows:
            run.append_results_row(r)
        paths.append(run.path)
    for name in ("args.yaml", "results.csv"):
        assert (paths[0] / name).read_bytes() == (paths[1] / name).read_bytes(), name
    back = yaml.safe_load((paths[0] / "args.yaml").read_text(encoding="utf-8"))
    assert back == {**args, "data": str(args["data"])}
    assert port_artifacts.RESULTS_COLUMNS == jax_artifacts.RESULTS_COLUMNS


def test_run_dir_auto_increments_as_jax(tmp_path):
    got = [port_artifacts.RunDir(str(tmp_path / "p"), "exp").path.name for _ in range(3)]
    want = [jax_artifacts.RunDir(str(tmp_path / "j"), "exp").path.name for _ in range(3)]
    assert got == want == ["exp", "exp2", "exp3"]
    assert port_artifacts.RunDir(str(tmp_path / "p"), "exp", exist_ok=True).path.name == "exp"


# ---------------------------------------------------------------- PNG


def _image(h, w, c, seed=0):
    """Noise over gradients: every row filter cv2's encoder picks is used."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = (x * 3 + y * 5)[..., None] + np.arange(c) * 40
    return ((base + rng.integers(0, 9, (h, w, c))) % 256).astype(np.uint8)


@pytest.mark.parametrize("channels,level", [(1, 1), (3, 3), (3, 9), (4, 6)])
def test_png_reader_is_bit_exact_against_cv2(tmp_path, channels, level):
    import cv2

    img = _image(37, 53, channels)
    path = tmp_path / "x.png"
    cv2.imwrite(str(path), img if channels != 1 else img[..., 0],
                [cv2.IMWRITE_PNG_COMPRESSION, level])
    want = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(read_png(path), want)


def _png_with_filters(img: np.ndarray, colour: int) -> bytes:
    """A PNG whose row y uses filter y % 5: None, Sub, Up, Average, Paeth."""
    h, w, bpp = img.shape
    flat = img.reshape(h, w * bpp).astype(np.int64)
    rows = []
    for y in range(h):
        kind, cur = y % 5, flat[y]
        up = flat[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("colour,channels", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_png_reader_undoes_all_five_filters(tmp_path, colour, channels):
    import cv2

    img = _image(23, 19, channels, seed=colour)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filters(img, colour))
    got = read_png(path)
    want = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(got, want)
    rgb = np.repeat(img[..., :1], 3, 2) if channels <= 2 else img[..., :3]
    np.testing.assert_array_equal(got, rgb)


def test_png_writer_round_trips_through_cv2(tmp_path):
    import cv2

    img = _image(31, 17, 3)
    write_png(tmp_path / "w.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "w.png"), img)
    back = cv2.cvtColor(cv2.imread(str(tmp_path / "w.png"), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(back, img)


def test_load_image_falls_back_to_the_png_reader(tmp_path, monkeypatch):
    """Without cv2 and PIL a PNG decodes with the port's reader; any other
    format raises and says what it needs."""
    import cv2

    img = _image(16, 24, 3)
    write_png(tmp_path / "a.png", img)
    cv2.imwrite(str(tmp_path / "a.jpg"), img)
    (tmp_path / "deep.png").write_bytes(_png_with_filters(img, 2).replace(
        struct.pack(">IIBBBBB", 24, 16, 8, 2, 0, 0, 0), struct.pack(">IIBBBBB", 24, 16, 16, 2,
                                                                   0, 0, 0)))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(port_letterbox.load_image(tmp_path / "a.png"), img)
    with pytest.raises(ValueError, match="not a PNG"):
        port_letterbox.load_image(tmp_path / "a.jpg")
    with pytest.raises(ValueError, match="bit depth 16"):
        port_letterbox.load_image(tmp_path / "deep.png")
