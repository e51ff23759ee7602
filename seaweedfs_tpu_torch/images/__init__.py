"""Image resize + EXIF orientation fix on read.

The port's copy of seaweedfs_tpu/images/__init__.py.

Reference: weed/images/resizing.go (?width/?height/?mode= on image GETs)
and orientation.go (JPEGs re-oriented per their EXIF tag before being
served).  Pillow replaces the imaging/Go stdlib pipeline; behavior
parity: mode "fit" preserves aspect inside the box, "fill" crops to
exactly fill it, default resizes to the requested dimensions (square
default on non-square input thumbnails, like imaging.Thumbnail).
"""

from __future__ import annotations

import io

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".gif", ".webp"}
IMAGE_MIMES = {"image/jpeg", "image/png", "image/gif", "image/webp"}


def is_image(ext: str = "", mime: str = "") -> bool:
    return ext.lower() in IMAGE_EXTS or mime.lower() in IMAGE_MIMES


def fix_orientation(data: bytes) -> bytes:
    """Apply the EXIF orientation tag (JPEG) and strip it
    (orientation.go FixJpgOrientation)."""
    try:
        from PIL import Image, ImageOps

        img = Image.open(io.BytesIO(data))
        if img.format != "JPEG":
            return data
        # only pay a re-encode when an actual rotation is recorded —
        # exif_transpose returns a copy even for orientation-free files,
        # so the tag itself is the no-op check
        if img.getexif().get(0x0112, 1) in (None, 0, 1):
            return data
        fixed = ImageOps.exif_transpose(img)
        out = io.BytesIO()
        fixed.save(out, format="JPEG", quality=90)
        return out.getvalue()
    except Exception:
        return data


def resized(data: bytes, ext: str, width: int = 0, height: int = 0,
            mode: str = "") -> tuple[bytes, int, int]:
    """-> (bytes, w, h); returns the input untouched when no resize
    applies (resizing.go Resized)."""
    if not width and not height:
        return data, 0, 0
    try:
        from PIL import Image, ImageOps

        img = Image.open(io.BytesIO(data))
        bw, bh = img.size
        if not ((width and bw > width) or (height and bh > height)):
            return data, bw, bh
        if mode == "fit":
            img.thumbnail((width or bw, height or bh),
                          Image.Resampling.LANCZOS)
            dst = img
        elif mode == "fill":
            dst = ImageOps.fit(img, (width or bw, height or bh),
                               Image.Resampling.LANCZOS)
        else:
            if width and height and width == height and bw != bh:
                dst = ImageOps.fit(img, (width, height),
                                   Image.Resampling.LANCZOS)
            else:
                # zero dimension: scale preserving aspect
                if not width:
                    width = max(1, bw * height // bh)
                if not height:
                    height = max(1, bh * width // bw)
                dst = img.resize((width, height),
                                 Image.Resampling.LANCZOS)
        fmt = {"jpg": "JPEG", "jpeg": "JPEG", "png": "PNG",
               "gif": "GIF", "webp": "WEBP"}.get(
            ext.lower().lstrip("."), img.format or "PNG")
        out = io.BytesIO()
        if fmt == "JPEG" and dst.mode not in ("RGB", "L"):
            dst = dst.convert("RGB")
        dst.save(out, format=fmt)
        return out.getvalue(), dst.size[0], dst.size[1]
    except Exception:
        return data, 0, 0
