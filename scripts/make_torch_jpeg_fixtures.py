"""Write the JPEG fixtures of the PyTorch port's image path.

    python scripts/make_torch_jpeg_fixtures.py [out_dir]

Writes seeded synthetic images with PIL into ``out_dir``
(``tests/fixtures/torch_jpeg`` by default):

* ``photo_<i>_<w>x<h>.jpg``: eight photo-sized JPEGs (500x375, 375x500,
  640x480 and 333x500, two of each; quality 90, PIL's default 4:2:0)
  of smooth gradients and shapes, for ``chip_smoke.py``'s image path
  (the ``.rec`` of JPEG records and the ``ImageFolderDataset``);
* ``small_444.jpg``, ``small_420.jpg``, ``small_grey.jpg``: three small
  JPEGs with 4:4:4 and 4:2:0 chroma and one grey channel, and
  ``small_pixels.npz``, PIL's decoded RGB pixels of each (a grey image
  converted to RGB), against which nvJPEG's decode is held on the card;
* ``small.png``: a PNG, which decode on the card must refuse.

The images are made here, from a seed, and committed; nothing is
fetched.
"""
import io
import os
import sys

import numpy as np
from PIL import Image, ImageDraw, ImageFilter

PHOTO_SIZES = [(500, 375), (375, 500), (640, 480), (333, 500)]


def photo(rng, w, h):
    """A smooth RGB scene: per-channel gradients and waves, then a few
    filled shapes, blurred a little."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    chans = []
    for _ in range(3):
        a, b = rng.uniform(-1, 1, 2)
        fy, fx = rng.uniform(1, 6, 2) / max(w, h)
        ph = rng.uniform(0, 2 * np.pi)
        c = 128 + 60 * (a * xx / w + b * yy / h) \
            + 50 * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
        chans.append(c)
    img = Image.fromarray(np.clip(np.stack(chans, -1), 0, 255)
                          .astype(np.uint8))
    draw = ImageDraw.Draw(img)
    for _ in range(6):
        x0, x1 = sorted(rng.randint(0, w, 2))
        y0, y1 = sorted(rng.randint(0, h, 2))
        fill = tuple(int(v) for v in rng.randint(0, 256, 3))
        (draw.ellipse if rng.rand() < 0.5 else draw.rectangle)(
            [x0, y0, x1 + 1, y1 + 1], fill=fill)
    return img.filter(ImageFilter.GaussianBlur(1.5))


def jpeg_bytes(img, **kw):
    bio = io.BytesIO()
    img.save(bio, format="JPEG", **kw)
    return bio.getvalue()


def main(out_dir):
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(2026)
    for i in range(8):
        w, h = PHOTO_SIZES[i % len(PHOTO_SIZES)]
        with open(os.path.join(out_dir, f"photo_{i}_{w}x{h}.jpg"), "wb") as f:
            f.write(jpeg_bytes(photo(rng, w, h), quality=90))
    pixels = {}
    small = photo(rng, 67, 45)
    cases = {"small_444": (small, dict(quality=90, subsampling=0)),
             "small_420": (small, dict(quality=90, subsampling=2)),
             "small_grey": (small.convert("L"), dict(quality=90))}
    for name, (img, kw) in cases.items():
        data = jpeg_bytes(img, **kw)
        with open(os.path.join(out_dir, name + ".jpg"), "wb") as f:
            f.write(data)
        pixels[name] = np.asarray(Image.open(io.BytesIO(data))
                                  .convert("RGB"))
    np.savez_compressed(os.path.join(out_dir, "small_pixels.npz"), **pixels)
    small.save(os.path.join(out_dir, "small.png"))
    total = sum(os.path.getsize(os.path.join(out_dir, f))
                for f in os.listdir(out_dir))
    print(f"wrote {len(os.listdir(out_dir))} files, {total} bytes, to "
          f"{out_dir}")


if __name__ == "__main__":
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    main(sys.argv[1] if len(sys.argv) > 1 else
         os.path.join(here, "tests", "fixtures", "torch_jpeg"))
