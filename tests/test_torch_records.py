"""The port's TFRecord shards and native library (``native/loader.py``,
``data/records.py``, ``data/png.py``'s encoder) against the JAX package's,
on the CPU. Both packages build the same C++ (``io.cc``, ``records.cc``)
from their own copies, so every comparison here is bit for bit: the framing
bytes, the ``.idx`` sidecars' arrays, the native reader's order at shuffle
buffers 1 and 16, range reads, blob and file decodes (grey, RGB, JPEG, a
resize), and ``ClassificationRecords``' train and padded eval batches. The
pure-Python reader stays the plain version the native one is held to.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zipfile

import numpy as np
import pytest
from PIL import Image

from tensorflowdistributedlearning_tpu import cli as jcli
from tensorflowdistributedlearning_tpu.data import records as jrec
from tensorflowdistributedlearning_tpu.native import loader as jloader
from tensorflowdistributedlearning_tpu_torch.__main__ import main as cli_main
from tensorflowdistributedlearning_tpu_torch.data import png as tpng
from tensorflowdistributedlearning_tpu_torch.data import records as trec
from tensorflowdistributedlearning_tpu_torch.native import loader as tloader


def _payloads(n=20, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes() for _ in range(n)]


def _images(n, hw=12, channels=3, seed=1):
    rng = np.random.default_rng(seed)
    shape = (hw, hw, channels) if channels > 1 else (hw, hw)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """40 classification records of 12x12 RGB in 3 shards, written by the
    port, and the same images written by the JAX package."""
    root = tmp_path_factory.mktemp("records")
    images = _images(40)
    labels = list(np.random.default_rng(2).integers(0, 5, 40))
    port = trec.write_classification_shards(str(root / "port"), images, labels, shards=3)
    jax_paths = jrec.write_classification_shards(str(root / "jax"), images, labels, shards=3)
    return dict(port=port, jax=jax_paths, images=images, labels=labels, root=root)


def test_both_packages_run_their_native_libraries():
    assert jrec._records_lib() is not None and jloader.native_available()
    assert tloader.records_library() is not None and tloader.native_available()
    assert tloader.decoder() == "native" and tloader.jpeg_available()
    # two libraries: the port's own build, not the JAX package's
    assert os.path.dirname(tloader.library_path("io", ())) != os.path.dirname(jloader._LIB)


def test_masked_crc_matches_jax_and_the_native_one():
    for blob in [b"", b"123456789", *_payloads(8)]:
        want = jrec.masked_crc(blob)
        assert trec.masked_crc(blob) == want == tloader.masked_crc32c(blob)
    assert trec.masked_crc(b"") == 0xA282EAD8


def test_framing_and_index_bytes_match_jax(tmp_path):
    data = _payloads(30)
    trec.write_records(str(tmp_path / "t.tfrecord"), data)
    jrec.write_records(str(tmp_path / "j.tfrecord"), data)
    assert (tmp_path / "t.tfrecord").read_bytes() == (tmp_path / "j.tfrecord").read_bytes()
    got = trec.write_shard_index(str(tmp_path / "t.tfrecord"))
    want = jrec.write_shard_index(str(tmp_path / "j.tfrecord"))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    with zipfile.ZipFile(str(tmp_path / "t.tfrecord.idx")) as a, zipfile.ZipFile(str(tmp_path / "j.tfrecord.idx")) as b:
        assert a.namelist() == b.namelist() == ["offsets.npy", "file_size.npy"]
        for name in a.namelist():
            assert a.read(name) == b.read(name)
    assert list(trec.read_records(str(tmp_path / "j.tfrecord"))) == data
    # a rewrite drops the stale sidecar
    trec.write_records(str(tmp_path / "t.tfrecord"), data[:3])
    assert not os.path.exists(str(tmp_path / "t.tfrecord.idx"))


def test_classification_shards_decode_to_the_pixels_written(shards):
    """The port encodes PNGs with its own codec (other bytes than PIL's),
    the JAX package with PIL: both decode to the pixels written."""
    for key in ("port", "jax"):
        paths = shards[key]
        for s, path in enumerate(paths):
            assert [os.path.basename(p) for p in paths][s] == f"train-{s:05d}-of-00003.tfrecord"
            rows = range(s, 40, 3)
            for i, payload in zip(rows, trec.read_records(path)):
                label, blob = trec.decode_classification_record(payload)
                assert label == shards["labels"][i]
                pixels = np.asarray(Image.open(io.BytesIO(blob)))
                assert np.array_equal(pixels, shards["images"][i])
                assert np.array_equal(tpng.read_png(blob), shards["images"][i])
    assert trec.count_records(shards["port"]) == jrec.count_records(shards["jax"]) == 40


@pytest.mark.parametrize("shuffle", [1, 16])
def test_record_stream_order_matches_jax(shards, shuffle):
    paths = shards["port"]
    for seed in (0, 5):
        got = list(trec.RecordStream(paths, shuffle_buffer=shuffle, seed=seed))
        want = list(jrec.RecordStream(paths, shuffle_buffer=shuffle, seed=seed))
        assert got == want
    assert sorted(got) == sorted(b for p in paths for b in trec.read_records(p))


def test_record_stream_is_the_python_reader_on_one_shard(shards):
    path = shards["port"][0]
    assert list(trec.RecordStream([path], shuffle_buffer=1)) == list(trec.read_records(path))


def test_range_reader_matches_jax_and_the_python_reader(shards):
    path = shards["port"][1]
    offsets = trec.shard_offsets(path)
    order = np.random.default_rng(0).permutation(len(offsets))
    plain = list(trec.read_records(path))
    with trec.ShardRangeReader(path) as reader:
        got = reader.read(offsets[order])
        again = reader.read(offsets[:2])
    want = jrec.ShardRangeReader(path).read(offsets[order])
    assert got == want == [plain[i] for i in order]
    assert again == plain[:2]
    with pytest.raises(RuntimeError, match="closed"):
        reader.read(offsets[:1])


def test_corruption_and_truncation_raise_as_in_jax(tmp_path):
    path = str(tmp_path / "bad.tfrecord")
    trec.write_records(path, _payloads(5))
    raw = bytearray(open(path, "rb").read())
    raw[20] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="corrupt"):
        list(trec.RecordStream([path]))
    with pytest.raises(ValueError, match="corrupt"):
        list(trec.read_records(path))
    with pytest.raises(ValueError, match="corrupt"):
        list(jrec.RecordStream([path]))
    # a shard cut mid-record is counted as truncated, not whole
    cut = str(tmp_path / "cut.tfrecord")
    trec.write_records(cut, _payloads(4))
    open(cut, "r+b").truncate(os.path.getsize(cut) - 3)
    with pytest.raises(ValueError, match="truncated"):
        trec.count_records([cut])
    with pytest.raises(ValueError, match="corrupt"):  # an offset past the end
        trec.ShardRangeReader(cut).read([0, 10_000])


def test_stale_or_corrupt_index_falls_back_to_the_scan(tmp_path):
    path = str(tmp_path / "a.tfrecord")
    trec.write_records(path, _payloads(6))
    want = trec.write_shard_index(path)
    np.savez(open(path + ".idx", "wb"), offsets=want[:2], file_size=np.int64(1))  # wrong size: stale
    assert np.array_equal(trec.shard_offsets(path), want)
    open(path + ".idx", "wb").write(b"garbage")
    assert np.array_equal(trec.shard_offsets(path), want) and trec.count_records([path]) == 6


def _blob(image: np.ndarray, fmt: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


@pytest.mark.parametrize("case", ["grey", "rgb", "rgba", "jpeg", "resize", "rgb-to-grey"])
def test_blob_and_file_decodes_match_jax(tmp_path, case):
    rng = np.random.default_rng(3)
    if case == "grey":
        images, fmt, shape, channels = [rng.integers(0, 256, (10, 14), dtype=np.uint8) for _ in range(5)], "PNG", \
            (10, 14), 3
    elif case == "rgba":
        images, fmt, shape, channels = [rng.integers(0, 256, (10, 14, 4), dtype=np.uint8) for _ in range(5)], \
            "PNG", (10, 14), 3
    elif case == "jpeg":
        images, fmt, shape, channels = _images(5, 16), "JPEG", (16, 16), 3
    elif case == "resize":
        images, fmt, shape, channels = [rng.integers(0, 256, (20 + i, 9 + 3 * i, 3), dtype=np.uint8)
                                        for i in range(5)], "PNG", (12, 11), 3
    elif case == "rgb-to-grey":
        images, fmt, shape, channels = _images(5, 12), "PNG", (12, 12), 1
    else:
        images, fmt, shape, channels = _images(5, 12), "PNG", (12, 12), 3
    blobs = [_blob(im, fmt) for im in images]
    got = tloader.decode_image_blobs(blobs, shape, channels)
    want = jloader.decode_image_blobs(blobs, shape, channels)
    assert got.dtype == np.float32 and got.shape == (5, *shape, channels)
    assert np.array_equal(got, want)
    paths = []
    for i, blob in enumerate(blobs):
        paths.append(str(tmp_path / f"{i}.{fmt.lower()}"))
        open(paths[-1], "wb").write(blob)
    files = tloader.decode_image_batch(paths, *shape, channels=channels)
    assert np.array_equal(files, jloader.decode_image_batch(paths, *shape, channels=channels))
    assert np.array_equal(files, got)


@pytest.fixture
def no_native_decoder(monkeypatch):
    """The port as on a host where io.cc does not build."""
    monkeypatch.setitem(tloader._libs, "io", None)
    assert tloader.decoder() == "png.py" and not tloader.jpeg_available()


@pytest.mark.parametrize("channels, image_channels", [(3, 3), (3, 1), (1, 3), (3, 4), (1, 1)])
def test_png_py_decodes_what_the_native_decoder_gives(tmp_path, monkeypatch, channels, image_channels):
    images = _images(4, 12, channels=image_channels, seed=image_channels)
    blobs = [tpng.encode_png(im) for im in images] + [_blob(images[0], "PNG")]
    native = tloader.decode_image_blobs(blobs, (12, 12), channels)
    monkeypatch.setitem(tloader._libs, "io", None)
    assert tloader.decoder() == "png.py"
    assert np.array_equal(tloader.decode_image_blobs(blobs, (12, 12), channels), native)
    path = str(tmp_path / "a.png")
    open(path, "wb").write(blobs[1])
    assert np.array_equal(tloader.decode_image_batch([path], 12, 12, channels=channels), native[1:2])


def test_without_the_native_decoder_jpegs_and_resizes_raise(tmp_path, no_native_decoder):
    jpeg = _blob(_images(1, 12)[0], "JPEG")
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        tloader.decode_image_blobs([tpng.encode_png(_images(1, 12)[0]), jpeg], (12, 12), 3)
    with pytest.raises(RuntimeError, match="image blob 0 of 1 is 12x12, not 8x8: a resize needs .*png.h"):
        tloader.decode_image_blobs([tpng.encode_png(_images(1, 12)[0])], (8, 8), 3)
    path = str(tmp_path / "a.jpg")
    open(path, "wb").write(jpeg)
    with pytest.raises(RuntimeError, match="a.jpg is a JPEG"):
        tloader.decode_image_batch([path], 12, 12)


def test_a_blob_the_native_decoder_rejects_raises_with_its_index():
    good = tpng.encode_png(_images(1, 8)[0])
    with pytest.raises(ValueError, match="image blob 2 of 3"):
        tloader.decode_image_blobs([good, good, b"not an image"], (8, 8), 3)


@pytest.mark.parametrize("shape", [(7, 5), (9, 4, 1), (6, 3, 3), (4, 8, 4)])
def test_encode_png_round_trips_through_pil(shape):
    image = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    decoded = np.asarray(Image.open(io.BytesIO(tpng.encode_png(image))))
    assert np.array_equal(decoded.reshape(image.shape), image)
    assert np.array_equal(tpng.read_png(tpng.encode_png(image)).reshape(image.shape), image)


def _batches(ds, n, **kw):
    out = []
    for b in ds.batches(6, **kw):
        out.append(b)
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("mode", ["train", "train-inline", "eval-padded", "eval"])
def test_classification_records_batches_match_jax(shards, mode):
    root = os.path.dirname(shards["port"][0])
    kw = dict(image_shape=(12, 12), channels=3, num_classes=5)
    port, jax_ds = trec.ClassificationRecords(root, **kw), jrec.ClassificationRecords(root, **kw)
    if mode.startswith("train"):
        args = dict(seed=3, shuffle_buffer=16, steps=9, decode_ahead=0 if mode == "train-inline" else 1)
    elif mode == "eval-padded":
        args = dict(repeat=False, pad_to_batches=9)
    else:
        args = dict(repeat=False)
    got, want = list(port.batches(6, **args)), list(jax_ds.batches(6, **args))
    assert len(got) == len(want) == (9 if mode != "eval" else 7)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b) == ["images", "labels", "valid"]
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    if mode.startswith("eval"):
        assert sum(float(b["valid"].sum()) for b in got) == 40


def test_host_shard_paths_match_jax(shards):
    paths = shards["port"] * 2
    for count in (1, 2, 3, 4):
        for index in range(count):
            assert trec.host_shard_paths(paths, index, count) == jrec.host_shard_paths(paths, index, count)
    assert trec.host_shard_paths(paths) == sorted(paths)


def test_native_build_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setenv("TFDL_TORCH_BUILD_DIR", str(tmp_path))
    a, b = tloader.library_path("io", ("-lpng",)), tloader.library_path("io", ("-lpng", "-ljpeg"))
    assert a != b and os.path.dirname(a) == str(tmp_path / "native")
    path, err = tloader.compile_library("records", ())
    assert path == tloader.library_path("records", ()) and os.path.exists(path) and err == ""
    assert not [f for f in os.listdir(tmp_path / "native") if f.endswith(".tmp")]


def test_records_index_command_matches_jax(shards, tmp_path, capsys):
    data = _payloads(7)
    for d in ("port", "jax"):
        for s in range(2):
            trec.write_records(str(tmp_path / d / f"train-{s}.tfrecord"), data[s:])
    assert cli_main(["records-index", str(tmp_path / "port")]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert jcli.main(["records-index", str(tmp_path / "jax")]) == 0
    want = capsys.readouterr().out.strip().splitlines()
    assert json.loads(got[-1]) == json.loads(want[-1]) == {"shards": 2, "records": 13}
    assert [line.split("/")[-1] for line in got[:-1]] == [line.split("/")[-1] for line in want[:-1]]
    assert cli_main(["records-index", str(tmp_path / "empty")]) == 1


def test_payload_codec_matches_jax():
    for label in (0, 7, -1, 2**31 - 1):
        payload = trec.encode_classification_record(label, b"png")
        assert payload == jrec.encode_classification_record(label, b"png") == struct.pack("<i", label) + b"png"
        assert trec.decode_classification_record(payload) == (label, b"png")
    with pytest.raises(ValueError, match="label out of range"):
        trec.check_classification_labels(np.asarray([0, 5]), 5)


def test_retry_matches_jax():
    """``resilience/retry.py``: the backoff schedule is JAX's; transient
    ``OSError``s retry and count, deterministic ones re-raise at once,
    exhaustion chains the last error."""
    import random

    from tensorflowdistributedlearning_tpu.resilience import retry as jretry
    from tensorflowdistributedlearning_tpu_torch.resilience import retry as tretry

    kw = dict(base_delay_s=0.05, max_delay_s=2.0, jitter_frac=0.25)
    a, b = random.Random(3), random.Random(3)
    assert [tretry.backoff_delay(n, rng=a, **kw) for n in range(1, 9)] == \
        [jretry.backoff_delay(n, rng=b, **kw) for n in range(1, 9)]
    tretry.reset_registry()
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert tretry.call_with_retry(flaky, name="t", sleep=slept.append) == "ok"
    assert tretry.retries("t") == 2 == len(slept) and tretry.retries() == 2
    with pytest.raises(FileNotFoundError):
        tretry.call_with_retry(lambda: open("/nonexistent/shard"), name="t", sleep=slept.append)
    assert tretry.retries("t") == 2
    with pytest.raises(tretry.RetryExhaustedError) as e:
        tretry.call_with_retry(lambda: (_ for _ in ()).throw(OSError("down")), name="u", attempts=2,
                               sleep=slept.append)
    assert isinstance(e.value.__cause__, OSError) and e.value.attempts == 2 and not isinstance(e.value, OSError)
