"""The port's TensorBoard writer (``utils/summary.py``) against the JAX
package's, on the CPU: JAX's ``read_events`` reads the port's event files,
the scalar records are byte for byte JAX's writer's at a fixed wall time,
and the image summaries decode (by the port's ``read_images``, over
``data/png.py``, and by PIL) to the pixels written, as JAX's writer's do.
Exact equality throughout: the formats are bytes, and scalars are float32
on the wire in both."""

from __future__ import annotations

import glob
import io
import os

import numpy as np
import pytest
from PIL import Image

from tensorflowdistributedlearning_tpu.utils import summary as jsummary
from tensorflowdistributedlearning_tpu_torch.utils import summary as tsummary

SCALARS = [({"loss": 0.6931471805599453, "metrics/mean_iou": 0.25, "lr": 1e-3}, 20),
           ({"loss": 0.5, "throughput/images_per_sec": 1234.5678}, 40), ({"x": -3.0}, 2 ** 40)]


def _write(lib, logdir, images=()):
    writer = lib.SummaryWriter(logdir)
    for values, step in SCALARS:
        writer.scalars(values, step)
    writer.scalar("single", 7.25, 41)
    for tag, image, step in images:
        writer.image(tag, image, step)
    writer.close()
    (path,) = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    return path


def _images():
    rng = np.random.default_rng(0)
    gray = rng.uniform(size=(33, 17)).astype(np.float32)
    return [("image/0", gray, 20), ("label/0", (gray > 0.5).astype(np.float32), 20),
            ("probability/0", gray[..., None], 40), ("rgb/0", rng.integers(0, 255, (9, 11, 3), dtype=np.uint8), 40)]


def test_jaxs_reader_reads_the_ports_scalars(tmp_path):
    path = _write(tsummary, str(tmp_path / "port"), _images())
    want = jsummary.read_events(_write(jsummary, str(tmp_path / "jax")))
    assert jsummary.read_events(path) == tsummary.read_events(path) == want
    assert [s for s, _ in want] == [20, 40, 2 ** 40, 41]
    assert want[0][1]["loss"] == pytest.approx(0.6931471805599453, rel=1e-7)


def test_scalar_records_are_jaxs_bytes_at_a_fixed_wall_time(tmp_path, monkeypatch):
    for lib in (jsummary, tsummary):
        monkeypatch.setattr(lib.time, "time", lambda: 1_700_000_000.25)
    ports = open(_write(tsummary, str(tmp_path / "port")), "rb").read()
    jaxs = open(_write(jsummary, str(tmp_path / "jax")), "rb").read()
    assert ports == jaxs and len(ports) > 100


def test_images_decode_to_the_pixels_written(tmp_path):
    images = _images()
    path = _write(tsummary, str(tmp_path / "port"), images)
    decoded = {}
    for step, by_tag in tsummary.read_images(path):
        for tag, pixels in by_tag.items():
            decoded[(tag, step)] = pixels
    assert len(decoded) == len(images)
    for tag, image, step in images:
        want = image if image.dtype == np.uint8 else (np.clip(image, 0.0, 1.0) * 255.0).astype(np.uint8)
        want = want[..., 0] if want.ndim == 3 and want.shape[-1] == 1 else want
        np.testing.assert_array_equal(decoded[(tag, step)], want)
    # PIL decodes the port's PNG bytes as it decodes the JAX writer's
    jpath = _write(jsummary, str(tmp_path / "jax"), images)
    for p in (path, jpath):
        pngs = [v for _, v in _png_payloads(p)]
        assert len(pngs) == len(images)
        for (tag, image, step), png in zip(images, pngs):
            np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))), decoded[(tag, step)])


def _png_payloads(path):
    """(tag, PNG bytes) of every image value, through the port's parser."""
    for payload in tsummary._records(path):
        _, values = tsummary._summary_values(payload)
        for tag, kind, msg in values:
            if kind == 4:
                yield tag, next(v for f, _, v in tsummary._fields(msg) if f == 4)
