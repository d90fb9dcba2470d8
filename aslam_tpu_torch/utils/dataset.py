"""Dataset loading: TUM RGB-D association files and PNG decoding.

Port of `aslam_tpu/utils/dataset.py`.  Images decode through the native C++
loader (`aslam_tpu_torch.native`: zlib inflate and a prefetcher of worker
threads), built at first use; where that library cannot be built, through
`decode_png_zlib` below, which needs only the standard library's `zlib` and
numpy (8-bit gray / RGB / RGBA and 16-bit gray, non-interlaced, the five PNG
filters).  `TumSequence` prints which of the two it uses.  `write_png` is
the matching encoder, for fabricating a TUM-layout directory from rendered
frames (`write_tum_sequence`).
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from aslam_tpu_torch.native import loader as native_loader

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # PNG colour type -> channels


@dataclass
class TumAssociations:
    timestamps: np.ndarray        # [F] float64
    rgb_paths: list[str]
    depth_paths: list[str]


def load_associations(dataset_dir: str,
                      filename: str = "associations.txt") -> TumAssociations:
    """Parse a TUM association file: `t_rgb rgb_path t_depth depth_path`
    per line."""
    ts, rgbs, depths = [], [], []
    with open(os.path.join(dataset_dir, filename)) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 4:
                continue
            ts.append(float(parts[0]))
            rgbs.append(os.path.join(dataset_dir, parts[1]))
            depths.append(os.path.join(dataset_dir, parts[3]))
    return TumAssociations(np.asarray(ts, np.float64), rgbs, depths)


def associate(rgb_list: list[tuple[float, str]],
              depth_list: list[tuple[float, str]],
              max_dt: float = 0.02) -> list[tuple[float, str, str]]:
    """Greedy nearest-timestamp association of rgb.txt / depth.txt entries,
    for datasets that ship without an associations.txt (the contract of
    TUM's associate.py)."""
    out = []
    j = 0
    for t, rgb in rgb_list:
        while j + 1 < len(depth_list) and \
                abs(depth_list[j + 1][0] - t) <= abs(depth_list[j][0] - t):
            j += 1
        if abs(depth_list[j][0] - t) <= max_dt:
            out.append((t, rgb, depth_list[j][1]))
    return out


# ------------------------------------------------------------- PNG, by zlib

def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """PNG scanlines [H, 1 + stride] uint8 (filter byte first) -> the
    reconstructed bytes [H, stride]."""
    ftype, rows = raw[:, 0], raw[:, 1:]
    H, stride = rows.shape
    if (ftype == 0).all():
        return rows
    if (ftype == 2).all():                    # Up throughout: a column sum
        return np.cumsum(rows, axis=0, dtype=np.uint8)
    out = np.empty_like(rows)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        f, line = int(ftype[y]), rows[y]
        if f == 0:
            cur = line
        elif f == 1:                          # Sub: a running sum per byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif f == 2:                          # Up
            cur = line + prev
        elif f in (3, 4):                     # Average, Paeth: left to right
            cur_b = bytearray(stride)
            up, src = prev.tolist(), line.tolist()
            for i in range(stride):
                a = cur_b[i - bpp] if i >= bpp else 0
                b = up[i]
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur_b[i] = (src[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur_b), np.uint8)
        else:
            raise ValueError(f"PNG filter type {f}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png_zlib(path: str) -> np.ndarray:
    """Decode a non-interlaced 8-bit (gray, gray+alpha, RGB, RGBA) or 16-bit
    gray PNG -> uint8 [H,W] / [H,W,C] or uint16 [H,W]."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, bits, ctype, _, _, interlace = header
    if interlace or ctype not in _CHANNELS or bits not in (8, 16) \
            or (bits == 16 and ctype != 0):
        raise ValueError(f"{path}: unsupported PNG (bit depth {bits}, colour "
                         f"type {ctype}, interlace {interlace})")
    C = _CHANNELS[ctype]
    bpp = C * bits // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    data = _unfilter(raw.reshape(H, 1 + W * bpp), bpp)
    if bits == 16:
        return np.ascontiguousarray(data).view(">u2").astype(np.uint16) \
            .reshape(H, W)
    return data.reshape(H, W) if C == 1 else data.reshape(H, W, C)


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """Write uint8 [H,W] / [H,W,3] or uint16 [H,W] as a PNG (every scanline
    with the Up filter)."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        bits, ctype = 16, 0
        rows = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    elif img.dtype == np.uint8 and (img.ndim == 2 or img.shape[2] == 3):
        bits, ctype = 8, 0 if img.ndim == 2 else 2
        rows = img.reshape(img.shape[0], -1)
    else:
        raise ValueError(f"write_png: {img.dtype} {img.shape}")
    up = rows.copy()
    up[1:] -= rows[:-1]                        # uint8 arithmetic wraps
    scan = np.concatenate(
        [np.full((rows.shape[0], 1), 2, np.uint8), up], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body \
            + struct.pack(">I", zlib.crc32(kind + body))

    H, W = img.shape[:2]
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, bits, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(scan, level))
                + chunk(b"IEND", b""))


def write_tum_sequence(dataset_dir: str, imgs, depths, timestamps) -> None:
    """Fabricate a TUM-layout directory: `rgb/<t>.png` (uint8 gray or RGB),
    `depth/<t>.png` (uint16 counts) and `associations.txt`."""
    os.makedirs(os.path.join(dataset_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(dataset_dir, "depth"), exist_ok=True)
    lines = []
    for img, dep, t in zip(imgs, depths, timestamps):
        name = f"{t:.6f}.png"
        write_png(os.path.join(dataset_dir, "rgb", name), img)
        write_png(os.path.join(dataset_dir, "depth", name), dep)
        lines.append(f"{t:.6f} rgb/{name} {t:.6f} depth/{name}")
    with open(os.path.join(dataset_dir, "associations.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


# ------------------------------------------------------------------ loading

def decode_png(path: str) -> np.ndarray:
    """The native decoder where its library is there, else the zlib one."""
    img = native_loader.decode_png(path)
    return decode_png_zlib(path) if img is None else img


def _gray(img: np.ndarray) -> np.ndarray:
    """-> float32 grayscale [H,W] in [0,255] (ITU-R 601 weights for RGB)."""
    if img.ndim == 3:
        img = (0.299 * img[..., 0].astype(np.float32)
               + 0.587 * img[..., 1].astype(np.float32)
               + 0.114 * img[..., 2].astype(np.float32))
    return img.astype(np.float32)


def load_rgb_gray(path: str) -> np.ndarray:
    """Load an image as float32 grayscale [H,W] in [0,255]."""
    return _gray(decode_png(path))


def load_depth(path: str, depth_factor: float = 1.0 / 5000.0) -> np.ndarray:
    """Load a 16-bit depth PNG as float32 metres."""
    return decode_png(path).astype(np.float32) * depth_factor


class TumSequence:
    """Indexable RGB-D sequence -> (timestamp, gray float32 [H,W], depth
    float32 metres [H,W]), decoded ahead of the consumer: by the native
    prefetcher's worker threads, or by a thread pool around the zlib decoder
    (`lookahead=0` decodes in the caller's thread)."""

    def __init__(self, dataset_dir: str, depth_factor: float = 1.0 / 5000.0,
                 association_file: str = "associations.txt",
                 lookahead: int = 4, workers: int = 2, verbose: bool = True):
        self.assoc = load_associations(dataset_dir, association_file)
        self.depth_factor = depth_factor
        self.lookahead = lookahead
        self._pool = None
        self._native = None
        self._futures: dict[int, object] = {}
        if lookahead > 0:
            self._native = native_loader.NativePrefetcher.create(
                self.assoc.rgb_paths, self.assoc.depth_paths,
                lookahead=lookahead, workers=workers)
            if self._native is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(max_workers=workers)
        if native_loader.available():
            self.decoder = "native" + (" prefetcher" if self._native else "")
        else:
            self.decoder = f"zlib ({native_loader.BUILD_ERROR})"
        if verbose:
            print(f"TumSequence: {len(self)} frames in {dataset_dir}, PNG "
                  f"decoder: {self.decoder}", flush=True)

    def __len__(self) -> int:
        return len(self.assoc.rgb_paths)

    def _load(self, i: int):
        return (self.assoc.timestamps[i],
                load_rgb_gray(self.assoc.rgb_paths[i]),
                load_depth(self.assoc.depth_paths[i], self.depth_factor))

    def __getitem__(self, i: int):
        if self._native is not None:
            pair = self._native.get(i)
            if pair is None:
                return self._load(i)   # the zlib decoder raises with the reason
            rgb, depth = pair
            return (self.assoc.timestamps[i], _gray(rgb),
                    depth.astype(np.float32) * self.depth_factor)
        if self._pool is None:
            return self._load(i)
        # schedule the lookahead window, collect this frame
        for j in range(i, min(i + 1 + self.lookahead, len(self))):
            if j not in self._futures:
                self._futures[j] = self._pool.submit(self._load, j)
        return self._futures.pop(i).result()

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def close(self):
        if self._native is not None:
            self._native.close()
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
