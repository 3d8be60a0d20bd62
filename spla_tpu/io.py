"""MatrixMarket IO: loader with degree statistics, and save.

Equivalent of the reference MtxLoader (``include/spla/io.hpp:47-102``,
``src/io.cpp:50-157``): load with ``offset_indexes`` (1-based -> 0-based),
``make_undirected`` (mirror edges), ``remove_loops`` options; computes the
same degree statistics (min/max/avg/sd + power-of-two histogram) and can
save back.

The parse hot path is native C++ (``native/mtxio.cpp``: mmap +
hand-rolled scanning), loaded via ctypes and compiled on first use with a
pure-numpy fallback — mirroring the reference's C++-for-IO split.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

import numpy as np

__all__ = ["MtxLoader", "load_mtx"]

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_LIB = None
_LIB_TRIED = False


def _native_path(src: str) -> str:
    """Binary name keyed by the source's hash, the host's machine type and
    the compiler's target triple: a binary built from other sources or
    for another host (a copied checkout) is never loaded.  The build
    uses no ``-march=native``, so it runs on any CPU of its target."""
    import hashlib
    import platform

    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    try:
        target = subprocess.run(["g++", "-dumpmachine"], check=True,
                                capture_output=True, text=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        target = "unknown"
    h.update(f"{platform.machine()}/{target}".encode())
    return os.path.abspath(
        os.path.join(_NATIVE_DIR, f"libmtxio-{h.hexdigest()[:12]}.so"))


def _native_lib():
    """Compile (once) and load the native parser; None on failure."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    src = os.path.abspath(os.path.join(_NATIVE_DIR, "mtxio.cpp"))
    try:
        so = _native_path(src)
        if not os.path.exists(so):
            # build under a private name, then rename: concurrent builders
            # never load a half-written binary
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", src, "-o", tmp],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.mtx_parse.restype = ctypes.c_void_p
        lib.mtx_parse.argtypes = [ctypes.c_char_p]
        lib.mtx_error.restype = ctypes.c_char_p
        lib.mtx_error.argtypes = [ctypes.c_void_p]
        for f in ("mtx_n_rows", "mtx_n_cols", "mtx_nnz"):
            getattr(lib, f).restype = ctypes.c_int64
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        for f in ("mtx_pattern", "mtx_symmetric"):
            getattr(lib, f).restype = ctypes.c_int
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        lib.mtx_rows.restype = ctypes.POINTER(ctypes.c_int32)
        lib.mtx_rows.argtypes = [ctypes.c_void_p]
        lib.mtx_cols.restype = ctypes.POINTER(ctypes.c_int32)
        lib.mtx_cols.argtypes = [ctypes.c_void_p]
        lib.mtx_vals.restype = ctypes.POINTER(ctypes.c_double)
        lib.mtx_vals.argtypes = [ctypes.c_void_p]
        lib.mtx_release.restype = None
        lib.mtx_release.argtypes = [ctypes.c_void_p]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def _parse_native(path):
    lib = _native_lib()
    if lib is None:
        return None
    h = lib.mtx_parse(path.encode())
    try:
        err = lib.mtx_error(h)
        if err:
            raise IOError(f"mtx parse failed: {err.decode()}")
        nnz = lib.mtx_nnz(h)
        m, n = lib.mtx_n_rows(h), lib.mtx_n_cols(h)
        rows = np.ctypeslib.as_array(lib.mtx_rows(h), shape=(nnz,)).copy()
        cols = np.ctypeslib.as_array(lib.mtx_cols(h), shape=(nnz,)).copy()
        vp = lib.mtx_vals(h)
        vals = (
            np.ctypeslib.as_array(vp, shape=(nnz,)).copy()
            if vp and not lib.mtx_pattern(h)
            else np.ones(nnz, np.float64)
        )
        sym = bool(lib.mtx_symmetric(h))
        return m, n, rows, cols, vals, sym
    finally:
        lib.mtx_release(h)


def _parse_python(path):
    """Pure-numpy fallback parser."""
    sym = False
    with open(path, "rb") as f:
        header = f.readline().decode(errors="replace").lower()
        pattern = "pattern" in header
        sym = "symmetric" in header or "hermitian" in header or "skew" in header
        line = f.readline()
        while line.startswith(b"%"):
            line = f.readline()
        m, n, _ = (int(t) for t in line.split()[:3])
        data = np.loadtxt(f, ndmin=2)
    if data.size == 0:
        return m, n, np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0), sym
    rows = data[:, 0].astype(np.int32)
    cols = data[:, 1].astype(np.int32)
    vals = data[:, 2] if (data.shape[1] > 2 and not pattern) else np.ones(len(rows))
    return m, n, rows, cols, vals, sym


def _header_skew(path) -> bool:
    """True when the MatrixMarket banner declares skew-symmetric."""
    try:
        with open(path, "rb") as f:
            return b"skew-symmetric" in f.readline().lower()
    except OSError:  # pragma: no cover
        return False


@dataclass
class MtxLoader:
    """Reference-parity loader (``include/spla/io.hpp:47-102``)."""

    verbose: bool = True
    n_rows: int = 0
    n_cols: int = 0
    rows: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    cols: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    vals: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    stats: dict = field(default_factory=dict)

    @property
    def n_values(self) -> int:
        return int(self.rows.size)

    def load(
        self,
        path: str,
        offset_indexes: bool = True,
        make_undirected: bool = True,
        remove_loops: bool = True,
    ) -> "MtxLoader":
        t0 = time.perf_counter()
        parsed = _parse_native(path)
        native = parsed is not None
        if parsed is None:
            parsed = _parse_python(path)
        m, n, rows, cols, vals, sym = parsed
        t_parse = time.perf_counter() - t0

        if offset_indexes:
            rows = rows - 1
            cols = cols - 1
        if sym or make_undirected:
            keep = rows != cols  # do not duplicate diagonal
            # MatrixMarket skew-symmetric stores the lower triangle of
            # A = -A^T: the mirrored half carries NEGATED values (the
            # header keyword is not surfaced by the fast parser, so
            # detect it from the banner line directly)
            mirrored = -vals[keep] if (sym and _header_skew(path)) \
                else vals[keep]
            rows, cols, vals = (
                np.concatenate([rows, cols[keep]]),
                np.concatenate([cols, rows[keep]]),
                np.concatenate([vals, mirrored]),
            )
        if remove_loops:
            keep = rows != cols
            rows, cols, vals = rows[keep], cols[keep], vals[keep]

        self.n_rows, self.n_cols = int(m), int(n)
        self.rows, self.cols, self.vals = rows, cols, vals
        self._compute_stats(t_parse, native)
        if self.verbose:
            self._print_stats(path)
        return self

    def _compute_stats(self, t_parse, native):
        t0 = time.perf_counter()
        deg = np.bincount(self.rows, minlength=self.n_rows) if self.rows.size else np.zeros(1)
        hist_bins = np.zeros(0, np.int64)
        if deg.size:
            order = np.clip(np.ceil(np.log2(np.maximum(deg, 1))), 0, 62).astype(int)
            hist_bins = np.bincount(order)
        self.stats = {
            "n_rows": self.n_rows,
            "n_cols": self.n_cols,
            "n_values": self.n_values,
            "deg_min": int(deg.min()) if deg.size else 0,
            "deg_max": int(deg.max()) if deg.size else 0,
            "deg_avg": float(deg.mean()) if deg.size else 0.0,
            "deg_sd": float(deg.std()) if deg.size else 0.0,
            "distribution": hist_bins.tolist(),
            "parse_s": t_parse,
            "stats_s": time.perf_counter() - t0,
            "native_parser": native,
        }

    def _print_stats(self, path):
        s = self.stats
        print(
            f"Loaded {path}: {s['n_rows']}x{s['n_cols']} nnz={s['n_values']} "
            f"deg[min={s['deg_min']} max={s['deg_max']} avg={s['deg_avg']:.2f} "
            f"sd={s['deg_sd']:.2f}] parse={s['parse_s']:.3f}s "
            f"({'native' if s['native_parser'] else 'python'})",
            file=sys.stderr,
        )
        dist = s["distribution"]
        for i, c in enumerate(dist):
            if c:
                print(f"  deg <= 2^{i}: {c}", file=sys.stderr)

    def save(self, path: str) -> None:
        """Write back in MatrixMarket coordinate format (1-based).

        Vectorized formatting in chunks (the reference uses a buffered
        C++ writer, ``src/io.cpp:157+``; a Python per-line loop was ~30x
        slower on the 1-core host)."""
        chunk = 1 << 20
        with open(path, "w") as f:
            f.write("%%MatrixMarket matrix coordinate real general\n")
            f.write(f"{self.n_rows} {self.n_cols} {self.n_values}\n")
            for lo in range(0, self.n_values, chunk):
                hi = min(lo + chunk, self.n_values)
                r = self.rows[lo:hi] + 1
                c = self.cols[lo:hi] + 1
                v = self.vals[lo:hi]
                # one formatting pass per column, joined columnwise
                rc = np.char.add(
                    np.char.add(r.astype("U10"), " "), c.astype("U10")
                )
                vs = np.char.mod("%.9g", v)
                lines = np.char.add(np.char.add(rc, " "), vs)
                f.write("\n".join(lines.tolist()))
                f.write("\n")

    # conversion helpers
    def to_scipy(self):
        """CSR with the library's duplicate semantics (keep LAST — like the
        reference examples' set() loop), NOT scipy's default sum: a general
        file that stores both (i,j) and (j,i) plus make_undirected would
        otherwise silently double every such weight."""
        import scipy.sparse as sp

        key = self.rows.astype(np.int64) * self.n_cols + self.cols
        order = np.argsort(key, kind="stable")
        ks = key[order]
        last = np.empty(ks.size, bool)
        if ks.size:
            last[:-1] = ks[1:] != ks[:-1]
            last[-1] = True
        keep = order[last]
        a = sp.coo_matrix(
            (self.vals[keep], (self.rows[keep], self.cols[keep])),
            shape=(self.n_rows, self.n_cols),
        )
        return a.tocsr()

    def to_csr(self, dtype=np.float32, fill=0):
        from .formats import csr_from_scipy

        return csr_from_scipy(self.to_scipy().astype(dtype), fill=fill, dtype=dtype)


def load_mtx(path: str, **kw) -> MtxLoader:
    return MtxLoader(verbose=kw.pop("verbose", False)).load(path, **kw)
