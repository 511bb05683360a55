"""Write the JPEG fixture of the nvJPEG checks and the JAX package's decode
of it:

    PYTHONPATH=. python tests/data/make_jpeg_fixture.py

- synth_1008x756.jpg: frame 0 of the seeded synthetic LLFF scene at
  1008x756 (`vipnerf_tpu_torch.data.synthetic`), JPEG quality 90 with 4:2:0
  chroma subsampling (PIL's default at that quality), through imageio;
- synth_1008x756_decoded.png: that JPEG as the JAX package's `read_image`
  (vipnerf_tpu/utils/io.py, imageio: libjpeg) decodes it, written as PNG.

chip_smoke.py and tests/test_torch_kernels_cuda.py hold nvJPEG's decode on
the card against the PNG.
"""

import tempfile
from pathlib import Path

import imageio.v2 as imageio
import numpy as np

from vipnerf_tpu.utils.io import read_image
from vipnerf_tpu_torch.data.synthetic import write_synthetic_database

HERE = Path(__file__).resolve().parent
JPEG = HERE / "synth_1008x756.jpg"
DECODED = HERE / "synth_1008x756_decoded.png"


def main():
    with tempfile.TemporaryDirectory() as tmp:
        gt = write_synthetic_database(Path(tmp), num_frames=1, train_frames=(0,), val_frames=(0,),
                                      height=756, width=1008, with_sparse_depth=False,
                                      with_visibility_prior=False)
    frame = np.asarray(gt["images"][0])
    if frame.dtype != np.uint8:
        frame = np.round(frame * 255).astype(np.uint8)
    imageio.imwrite(JPEG, frame, quality=90, subsampling="4:2:0")
    imageio.imwrite(DECODED, read_image(JPEG))
    print(f"{JPEG.name}: {JPEG.stat().st_size} bytes; {DECODED.name}: {DECODED.stat().st_size} bytes")


if __name__ == "__main__":
    main()
