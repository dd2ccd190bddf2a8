"""Write the JPEG fixtures of the image decoder's tests with PIL, each beside
PIL's own decode of it as ``<name>.npy`` ((H, W, 3) uint8 RGB, PIL's
``Image.open(...).convert("RGB")``), and ``photo_a.png``: PIL's PNG of
``photo_a.npy``'s pixels, its rows filtered as PIL chooses (mostly Paeth).

    python tests/fixtures/images/make_fixtures.py

The pictures are seeded (numpy RandomState) and photo-like: smooth colour
gradients, noise, hard-edged coloured shapes (the edges where chroma
upsampling differs most between decoders) and a little text-like detail.
"""

from pathlib import Path

import numpy as np
from PIL import Image, ImageDraw

HERE = Path(__file__).resolve().parent
# name: (height, width, PIL mode, subsampling (0 = 4:4:4, 2 = 4:2:0), seed)
FIXTURES = {
    "rgb420": (60, 84, "RGB", 2, 1),
    "rgb444": (60, 84, "RGB", 0, 2),
    "grey": (60, 84, "L", None, 3),
    "photo_a": (480, 640, "RGB", 2, 4),
    "photo_b": (480, 640, "RGB", 2, 5),
}
QUALITY = 90


def picture(h: int, w: int, seed: int) -> Image.Image:
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([120 + 100 * np.sin(x / w * np.pi * (1 + seed % 3)),
                     120 + 90 * np.cos(y / h * np.pi * 2),
                     128 + 60 * np.sin((x + y) / (w + h) * np.pi * 3)], -1)
    base += rng.randn(h, w, 3) * 6
    im = Image.fromarray(np.clip(base, 0, 255).astype(np.uint8))
    draw = ImageDraw.Draw(im)
    for _ in range(6 + (h * w) // 20000):
        x0, y0 = rng.randint(0, w - 4), rng.randint(0, h - 4)
        x1, y1 = min(w - 1, x0 + rng.randint(4, w // 3)), min(h - 1, y0 + rng.randint(4, h // 3))
        colour = tuple(int(c) for c in rng.randint(0, 256, 3))
        if rng.rand() < 0.5:
            draw.rectangle([x0, y0, x1, y1], fill=colour)
        else:
            draw.ellipse([x0, y0, x1, y1], fill=colour)
    for _ in range(4):
        x0, y0 = rng.randint(0, w - 10), rng.randint(0, h - 10)
        draw.line([x0, y0, x0 + rng.randint(5, 40), y0 + rng.randint(-5, 5)],
                  fill=tuple(int(c) for c in rng.randint(0, 256, 3)), width=1)
    return im


def main() -> None:
    for name, (h, w, mode, subsampling, seed) in FIXTURES.items():
        im = picture(h, w, seed).convert(mode)
        path = HERE / f"{name}.jpg"
        kw = {} if subsampling is None else {"subsampling": subsampling}
        im.save(path, "JPEG", quality=QUALITY, **kw)
        np.save(HERE / f"{name}.npy", np.asarray(Image.open(path).convert("RGB")))
    Image.fromarray(np.load(HERE / "photo_a.npy")).save(HERE / "photo_a.png")


if __name__ == "__main__":
    main()
