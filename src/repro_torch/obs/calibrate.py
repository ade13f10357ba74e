"""CalibrationDB: measured effective roofline constants per (device, impl)
(counterpart of `repro.obs.calibrate`).

`repro_torch.obs.constants` holds what the card can do at its datasheet
peaks; the planner needs what each impl does. The DB stores, per

    (device kind x op kind x impl x tile geometry)

an effective `RooflineConstants` pair fitted from `profile_plan`
measurements, and every modeled time in the port (`unit_model_us`,
`plan_model_us`, `plan_network`'s arbitration) reads it through an explicit
`calibration=` parameter. The datasheet defaults stay the fallback for every
key the DB does not cover, so an empty DB plans bit-identically.

The geometry axis is the full `TileConfig` 5-tuple key (block_c, block_o,
bt, bf, bd); block_c-only entries embed as (block_c, 0, 0, 0, 0), which is
also how a v1 JSON loads. Lookup walks exact tile -> block_c-only ->
geometry-agnostic (all zero), so a coarse fit covers finer keys until one
is measured.

The DB also carries the tile-search winners (`put_tile` / `best_tile`): per
(device, op kind, impl, layer shape) the measured-best `TileConfig` key
that `obs.tilesearch` found, which `plan_network(tiles=...)` stamps on the
plan.

Fit model: one efficiency scalar per key. A kernel is taken to run at a
fixed fraction `s` of the datasheet roofline (both ceilings scaled
together): s = median over layers of (modeled_default_us / measured_us),
and the effective constants are defaults x s. The residual spread is kept
so a caller can see when one scalar does not explain an impl across shapes.

Persistence is JSON in the reference's `calibration-v2` schema (v1 files
load too), so a DB saved by either package loads in the other.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass

from repro_torch.obs import constants
from repro_torch.obs.constants import RooflineConstants


def device_kind(device=None) -> str:
    """The device axis of the DB: the card's name
    (`torch.cuda.get_device_name`) for a CUDA device, "cpu" for the host.
    `device` None means the card when one is present, else the host."""
    import torch

    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def unit_shape_key(unit) -> tuple:
    """The layer-shape key the tile winners are indexed by: (c, h, w, o, k,
    stride, pool) of a `graph.ir.ConvUnit` (duck-typed, so obs needs no
    graph import). Two units with equal keys face the same search."""
    c, h, w = unit.in_shape
    conv = unit.conv
    pool = unit.pool.p if unit.pool is not None else 0
    return (int(c), int(h), int(w), int(conv.c_out), int(conv.k),
            int(conv.stride), int(pool))


def _tile_key(block_c: int = 0, tile=None) -> tuple:
    """Normalize (block_c, tile) to the canonical 5-tuple geometry key."""
    if tile is not None and tile:
        return tuple(int(v) for v in tile.key())
    return (int(block_c), 0, 0, 0, 0)


def _fmt_tkey(tkey: tuple) -> str:
    if not any(tkey[1:]):
        return f"bc{tkey[0]}"
    return "t" + ".".join(str(v) for v in tkey)


@dataclass(frozen=True)
class CalibEntry:
    """One fitted key: the effective constants plus fit diagnostics."""

    peak_flops: float
    hbm_bw: float
    scale: float  # fitted efficiency against the datasheet defaults
    n_samples: int
    resid_spread: float  # (max-min)/median of the per-layer ratios

    def constants(self) -> RooflineConstants:
        return RooflineConstants(self.peak_flops, self.hbm_bw)


class CalibrationDB:
    """{(device_kind, kind, impl, tile_key): CalibEntry} with default fallback,
    plus {(device_kind, kind, impl, shape_key): tile_key} search winners.

    `lookup` tries the exact tile geometry, then the block_c-only key, then
    the geometry-agnostic all-zero key, then gives up (None: the caller uses
    the defaults). `device` pins the device axis: entries fitted on another
    device kind are never read (a host calibration must not steer a card's
    plan).
    """

    def __init__(self, entries: dict | None = None, device: str | None = None,
                 tiles: dict | None = None):
        self.entries: dict = dict(entries or {})
        self.tiles: dict = dict(tiles or {})
        self.device = device

    def __len__(self) -> int:
        return len(self.entries)

    def __bool__(self) -> bool:
        # an empty DB is falsy on purpose: `calibration or None` treats "no
        # calibration" and "nothing fitted yet" alike; a DB holding only
        # tile winners still counts
        return bool(self.entries) or bool(self.tiles)

    def _device(self) -> str:
        if self.device is None:
            self.device = device_kind()
        return self.device

    def put(self, kind: str, impl: str, block_c: int, entry: CalibEntry,
            device: str | None = None, tile=None) -> None:
        key = (device or self._device(), kind, impl, _tile_key(block_c, tile))
        self.entries[key] = entry

    def lookup(self, kind: str, impl: str, block_c: int = 0,
               device: str | None = None, tile=None) -> RooflineConstants | None:
        dev = device or self._device()
        tkey = _tile_key(block_c, tile)
        chain = [tkey]
        if any(tkey[1:]):
            chain.append((tkey[0], 0, 0, 0, 0))  # block_c-only fit
        if tkey[0] != 0 or any(tkey[1:]):
            chain.append((0, 0, 0, 0, 0))  # geometry-agnostic fit
        for k in chain:
            e = self.entries.get((dev, kind, impl, k))
            if e is not None:
                return e.constants()
        return None

    def covers(self, kind: str, impl: str, block_c: int = 0,
               device: str | None = None, tile=None) -> bool:
        return self.lookup(kind, impl, block_c, device, tile=tile) is not None

    def constants_for(self, kind: str, impl: str, block_c: int = 0,
                      device: str | None = None, tile=None) -> RooflineConstants:
        """The effective constants of a key: calibrated, else the defaults
        (read at call time)."""
        return self.lookup(kind, impl, block_c, device, tile=tile) \
            or constants.DEFAULT_ROOFLINE

    # -- tile-search winners ---------------------------------------------------

    def put_tile(self, kind: str, impl: str, shape_key: tuple, tile,
                 device: str | None = None) -> None:
        """Record the measured-best geometry of one (impl, layer shape).
        `tile` is a TileConfig or its 5-tuple key; an all-zero / None tile
        means the defaults won and erases any stored winner."""
        key = (device or self._device(), kind, impl, tuple(shape_key))
        tkey = _tile_key(0, tile) if not isinstance(tile, tuple) else \
            tuple(int(v) for v in tile)
        if not any(tkey):
            self.tiles.pop(key, None)
        else:
            self.tiles[key] = tkey

    def best_tile(self, kind: str, impl: str, shape_key: tuple,
                  device: str | None = None):
        """The stored winner as a `TileConfig`, or None when the defaults
        are best (either can go straight to `run_unit(..., tile=...)`)."""
        tkey = self.tiles.get(
            (device or self._device(), kind, impl, tuple(shape_key)))
        if tkey is None:
            return None
        from repro_torch.kernels.tiles import TileConfig

        return TileConfig.from_key(tkey)

    # -- fitting -------------------------------------------------------------

    def fit_report(self, report) -> "CalibrationDB":
        """Fold a `ProfileReport` in: one entry per (kind, impl, geometry)
        group, scale = median(predicted_default / measured). Returns self."""
        base = constants.DEFAULT_ROOFLINE
        for (kind, impl), rows in report.by_impl().items():
            by_tk: dict = {}
            for t in rows:
                tk = tuple(getattr(t, "tile", ()) or ()) \
                    or (int(t.block_c), 0, 0, 0, 0)
                by_tk.setdefault(tk, []).append(t)
            for tk, grp in by_tk.items():
                ratios = sorted(t.ratio for t in grp)
                s = _median(ratios)
                if s <= 0.0:
                    continue  # degenerate measurement; keep the defaults
                spread = (ratios[-1] - ratios[0]) / max(s, 1e-12)
                self.entries[(report.device_kind, kind, impl, tk)] = CalibEntry(
                    peak_flops=base.peak_flops * s, hbm_bw=base.hbm_bw * s,
                    scale=float(s), n_samples=len(grp),
                    resid_spread=float(spread))
        if self.device is None:
            self.device = report.device_kind
        return self

    @classmethod
    def from_report(cls, report) -> "CalibrationDB":
        return cls(device=report.device_kind).fit_report(report)

    # -- persistence ----------------------------------------------------------

    def to_json(self) -> dict:
        return {"schema": "calibration-v2", "device": self.device,
                "entries": [
                    {"device": d, "kind": k, "impl": i, "tile": list(tk),
                     **asdict(e)}
                    for (d, k, i, tk), e in sorted(self.entries.items())],
                "tiles": [
                    {"device": d, "kind": k, "impl": i, "shape": list(sk),
                     "tile": list(tk)}
                    for (d, k, i, sk), tk in sorted(self.tiles.items())]}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "CalibrationDB":
        with open(path) as f:
            payload = json.load(f)
        schema = payload.get("schema")
        if schema not in ("calibration-v1", "calibration-v2"):
            raise ValueError(f"{path}: not a calibration DB "
                             f"(schema={schema!r})")
        db = cls(device=payload.get("device"))
        for row in payload["entries"]:
            # v1 rows carry "block_c"; v2 rows the full "tile" 5-tuple
            tk = tuple(row["tile"]) if "tile" in row else \
                (int(row["block_c"]), 0, 0, 0, 0)
            db.entries[(row["device"], row["kind"], row["impl"], tk)] = \
                CalibEntry(peak_flops=row["peak_flops"],
                           hbm_bw=row["hbm_bw"], scale=row["scale"],
                           n_samples=row["n_samples"],
                           resid_spread=row["resid_spread"])
        for row in payload.get("tiles", []):
            db.tiles[(row["device"], row["kind"], row["impl"],
                      tuple(row["shape"]))] = tuple(row["tile"])
        return db

    def history_rows(self) -> list:
        """The fitted entries as perf-history rows (scale and residual
        spread per key): `obs.history.calibration_rows(self)`."""
        from repro_torch.obs.history.records import calibration_rows

        return calibration_rows(self)

    def summary(self) -> dict:
        """JSON-ready digest (scales per key, winners per shape)."""
        out = {f"{d}/{k}/{i}/{_fmt_tkey(tk)}": round(e.scale, 6)
               for (d, k, i, tk), e in sorted(self.entries.items())}
        for (d, k, i, sk), tk in sorted(self.tiles.items()):
            out[f"{d}/{k}/{i}/shape{'x'.join(map(str, sk))}"] = \
                _fmt_tkey(tk)
        return out


def _median(sorted_vals) -> float:
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    return float(sorted_vals[n // 2]) if n % 2 else \
        float((sorted_vals[n // 2 - 1] + sorted_vals[n // 2]) / 2)
