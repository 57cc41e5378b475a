"""Host-side image decode/encode.

Replaces the reference's vendored stb_image / tinyexr (src/LDRImage.h:40,
src/HDRImage.h:45-70):

  - PNG (8-bit gray / gray+alpha / RGB / RGBA, non-interlaced) encode and
    decode implemented here with zlib + numpy.  Decoded LDR values stay in
    **0..255** as float32, matching ``LDRImage::GetSample`` returning raw
    bytes.  Other LDR formats (JPEG, palette or 16-bit PNG, ...) go through
    Pillow, which is needed only when a scene names such a file.
  - EXR decode via a minimal built-in reader (uncompressed scanline files).
  - Radiance ``.hdr`` (RGBE) encode/decode implemented here directly —
    the reference writes .hdr via stb_image_write (src/main.cpp:191).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def load_image(path: str) -> tuple[np.ndarray, bool]:
    """Return (data (H,W,3) float32, is_hdr).

    LDR values stay in 0..255 like the reference byte samples; HDR (.exr/.hdr)
    are linear floats.
    """
    lower = path.lower()
    if lower.endswith(".exr"):
        return load_exr(path), True
    if lower.endswith(".hdr"):
        return read_hdr(path), True
    rgb = read_png(path) if _is_plain_png(path) else _load_with_pillow(path)
    return rgb.astype(np.float32), False


def _load_with_pillow(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: only 8-bit non-interlaced PNG, .exr and .hdr images "
            "are decoded natively; this file needs the Pillow package") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _is_plain_png(path: str) -> bool:
    """True for PNGs read_png decodes: 8-bit, no palette, non-interlaced."""
    with open(path, "rb") as f:
        head = f.read(29)
    if len(head) < 29 or head[:8] != _PNG_SIG or head[12:16] != b"IHDR":
        return False
    depth, ctype, _, _, interlace = head[24:29]
    return depth == 8 and ctype in _PNG_CHANNELS and interlace == 0


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced gray / gray+alpha / RGB / RGBA PNG to
    (H, W, 3) uint8.  Gray is replicated and alpha dropped, as Pillow's
    ``convert("RGB")`` does."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(raw):
        n, kind = struct.unpack_from(">I4s", raw, pos)
        body = raw[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG layout "
                         f"(depth {depth}, colour type {ctype})")
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    data = data[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = data[y, 0], data[y, 1:]
        if ftype == 0:  # None
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per channel
            cur = np.cumsum(line.reshape(w, bpp).astype(np.uint32), axis=0)
            cur = (cur % 256).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average / Paeth: sequential along the row
            cur = _unfilter_seq(ftype, line, prev, bpp)
        else:
            raise ValueError(f"{path}: bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    px = out.reshape(h, w, bpp)
    if bpp <= 2:
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def _unfilter_seq(ftype: int, line, prev, bpp: int) -> np.ndarray:
    cur = np.zeros(line.shape[0], np.int32)
    line = line.astype(np.int32)
    prev = prev.astype(np.int32)
    for i in range(line.shape[0]):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ftype == 3:
            pred = (a + b) // 2
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (line[i] + pred) & 0xFF
    return cur.astype(np.uint8)


def load_exr(path: str) -> np.ndarray:
    data = read_exr(path)
    if data.ndim == 2:
        data = np.stack([data] * 3, axis=-1)
    # RGBA -> RGB, mirroring HDRImage's RGBA->RGB repack (src/HDRImage.h:58-66)
    return np.ascontiguousarray(data[..., :3])


def write_exr(path: str, rgb: np.ndarray) -> None:
    """Write (H,W,3) float32 as a minimal OpenEXR 2.0 file: single part,
    scanline storage, NO_COMPRESSION, FLOAT channels.

    The capability the reference gets from tinyexr (decode only,
    src/HDRImage.h:45-70) plus the encode side it lacks; tinyexr reads this
    output (verified by the env-light cross-validation test).
    """
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape

    def attr(name: str, typ: str, value: bytes) -> bytes:
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<i", len(value)) + value)

    # channels MUST be sorted by name: B, G, R
    ch = b""
    for name in (b"B", b"G", b"R"):
        ch += name + b"\0" + struct.pack("<i", 2) + b"\0\0\0\0" \
            + struct.pack("<ii", 1, 1)
    ch += b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        struct.pack("<i", 20000630) + struct.pack("<i", 2)
        + attr("channels", "chlist", ch)
        + attr("compression", "compression", b"\0")
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\0")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0"
    )
    row_bytes = 8 + w * 3 * 4  # y + size prefix + BGR float rows
    table_start = len(header)
    data_start = table_start + 8 * h
    offsets = struct.pack("<%dQ" % h,
                          *[data_start + y * row_bytes for y in range(h)])
    with open(path, "wb") as f:
        f.write(header)
        f.write(offsets)
        for y in range(h):
            f.write(struct.pack("<ii", y, w * 3 * 4))
            f.write(rgb[y, :, 2].tobytes())  # B
            f.write(rgb[y, :, 1].tobytes())  # G
            f.write(rgb[y, :, 0].tobytes())  # R


def read_exr(path: str) -> np.ndarray:
    """Minimal OpenEXR reader: single-part uncompressed scanline images with
    HALF or FLOAT channels (covers write_exr output and tinyexr's
    NO_COMPRESSION files)."""
    with open(path, "rb") as f:
        raw = f.read()
    if struct.unpack_from("<i", raw, 0)[0] != 20000630:
        raise ValueError("not an EXR file")
    pos = 8
    channels: list[tuple[str, int]] = []
    compression = 0
    dw = (0, 0, 0, 0)
    while raw[pos] != 0:
        e = raw.index(b"\0", pos)
        name = raw[pos:e].decode()
        pos = e + 1
        e = raw.index(b"\0", pos)
        pos = e + 1
        size = struct.unpack_from("<i", raw, pos)[0]
        pos += 4
        val = raw[pos:pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while val[cp] != 0:
                ce = val.index(b"\0", cp)
                cname = val[cp:ce].decode()
                ptype = struct.unpack_from("<i", val, ce + 1)[0]
                channels.append((cname, ptype))
                cp = ce + 1 + 16
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            dw = struct.unpack("<iiii", val)
    pos += 1  # header terminator
    if compression != 0:
        raise ValueError("only NO_COMPRESSION EXR files supported")
    w = dw[2] - dw[0] + 1
    h = dw[3] - dw[1] + 1
    pos += 8 * h  # skip the offset table; blocks follow in order
    planes: dict[str, np.ndarray] = {
        c: np.zeros((h, w), np.float32) for c, _ in channels}
    for _ in range(h):
        y = struct.unpack_from("<i", raw, pos)[0] - dw[1]
        pos += 8
        for cname, ptype in channels:  # chlist order == file order
            if ptype == 2:  # FLOAT
                row = np.frombuffer(raw, "<f4", w, pos)
                pos += 4 * w
            elif ptype == 1:  # HALF
                row = np.frombuffer(raw, "<f2", w, pos).astype(np.float32)
                pos += 2 * w
            else:
                raise ValueError("UINT channels unsupported")
            planes[cname][y] = row
    if all(k in planes for k in ("R", "G", "B")):
        return np.stack([planes["R"], planes["G"], planes["B"]], axis=-1)
    first = planes[channels[0][0]]
    return np.stack([first] * 3, axis=-1)


def encode_png(rgb_u8: np.ndarray) -> bytes:
    """(H,W,3) uint8 -> 8-bit RGB PNG bytes, every scanline unfiltered."""
    img = np.ascontiguousarray(np.asarray(rgb_u8, dtype=np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"PNG encoder expects (H, W, 3) RGB, got {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                          axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    """Write (H,W,3) uint8 to PNG (reference: stbi_write_png, main.cpp:195)."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb_u8))


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """Write (H,W,3) float32 as Radiance RGBE .hdr (flat, no RLE).

    Matches the container stb_image_write produces (main.cpp:191); readers
    accept both RLE and flat scanlines.
    """
    rgb = np.asarray(rgb, dtype=np.float32)
    h, w, _ = rgb.shape
    maxc = rgb.max(axis=-1)
    # frexp: maxc = m * 2^e with m in [0.5, 1)
    m, e = np.frexp(maxc)
    scale = np.where(maxc > 1e-32, m * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc > 1e-32, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def read_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE reader (flat and adaptive-RLE scanlines)."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError("not a Radiance file")
        while True:
            line = f.readline().strip()
            if not line:
                break
        dims = f.readline().split()
        h, w = int(dims[1]), int(dims[3])
        data = f.read()

    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    pos = 0
    for y in range(h):
        if (
            len(data) - pos >= 4
            and data[pos] == 2
            and data[pos + 1] == 2
            and ((data[pos + 2] << 8) | data[pos + 3]) == w
        ):
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    cnt = data[pos]; pos += 1
                    if cnt > 128:  # run
                        rgbe[y, x : x + cnt - 128, c] = data[pos]
                        pos += 1
                        x += cnt - 128
                    else:  # literal
                        rgbe[y, x : x + cnt, c] = np.frombuffer(
                            data, np.uint8, cnt, pos
                        )
                        pos += cnt
                        x += cnt
        else:
            row = np.frombuffer(data, np.uint8, w * 4, pos).reshape(w, 4)
            rgbe[y] = row
            pos += w * 4

    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]
