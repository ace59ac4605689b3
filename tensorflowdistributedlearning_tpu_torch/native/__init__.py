"""Native (C++) host components of the port, built with ``g++`` at first use
and bound with ctypes (``loader.py``): the image decoder (``io.cc``) and the
TFRecord reader (``records.cc``), the port's own copies of the JAX
package's sources."""

from tensorflowdistributedlearning_tpu_torch.native.loader import (
    decode_image_batch,
    decode_image_blobs,
    decode_png_batch,
    decoder,
    native_available,
)

__all__ = ["decode_image_batch", "decode_image_blobs", "decode_png_batch", "decoder", "native_available"]
