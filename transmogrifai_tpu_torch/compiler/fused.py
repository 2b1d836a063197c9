"""The fused scoring graph, the port of the JAX package's
``compiler/fused.py``.

The staged loop runs each fitted stage over the batch in turn: the
vectorizers assemble the feature plane on the host, the plane goes up, the
predictor runs, its core comes down. The fused program runs the same plan
with one crossing each way:

* **ingest** stays on the host and shrinks to codecs: numeric values and
  validity masks, pivot codes (``ops.categorical.pivot_codes``: each
  distinct raw value resolved to its vocabulary column once), hashed-text
  (bucket, count) codes. These arrays are the batch's ONE upload
  (``compiler.dispatch``: one staging buffer, one copy);
* **on the device** every member's block is rebuilt from them (impute and
  null-track, the one-hot scatter, the hashed-text scatter), the blocks
  are concatenated into the plane, the SanityChecker's keep-index gathers
  are applied, and the predictor's device core runs (tree margins or mean
  leaves through ``trees.bin_data``, kernel K1 and the device-route tree
  sum; a GLM's float32 ``plane @ w + b``). The core is the ONE download;
  the host epilogue (``predictions_from_core``) is the float64 numpy the
  staged path runs too, so tree predictions are equal and GLMs differ only
  by the float32 core (within 1e-6).

There is no jit and no compiled-program bank: PyTorch runs eagerly, and
"one dispatch" is one upload, a run of launches with no host
synchronization, and one download. ``fingerprint`` (a hash of the
members', gathers' and predictor's descriptors) stays, because
``describe()`` reports it and the JAX package computes the same one.

A plan this module cannot fuse raises :class:`Unfuseable` at build, and a
batch whose text exceeds ``TPTPU_TEXT_FUSED_TOKENS`` distinct buckets in a
row raises it at ingest; the scoring closure sends such batches down the
staged loop and counts them. Any other error in a fused dispatch (a kernel
fault, a CUDA error) propagates: where the reference degrades to the staged
loop on any exception, the port does not, so a fault on the card is never
hidden behind a slower path.

The members' widths are cross-checked against the scoring closure's
``featurize.engine.FusionPlanner`` (the widths its batches learned) when
it has any. The scoring closure gates the route (``local/scoring.py``:
no installed fault plan, every covered stage's breaker closed) and guards
the prediction; each batch's upload and download land in the transfer
census (``telemetry/runlog.py``). ``run_explain`` adds the LOCO lanes of
``explain=k`` to the same run: the base core and every lane core, with
one upload and one download. Left for later: the executable bank and
warmup (A14).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .dispatch import StagingPool

__all__ = [
    "FusedServingProgram",
    "MemberPlan",
    "PredictorPlan",
    "Unfuseable",
    "build_fused_plan",
]


class Unfuseable(Exception):
    """The fitted plan (or, for the text cap, a batch) cannot go through
    the fused graph; the message names the first obstruction."""


@dataclasses.dataclass
class MemberPlan:
    """One combiner member's device twin: the host ``ingest`` (codecs
    only: columns -> named numpy arrays), the device ``kernel`` rebuilding
    the member's block ((ingest tensors, params tensors) -> [N, width]
    float32), and its fit-static ``params`` (numpy, uploaded once).
    ``quant`` is the hint for the quantized plane: ``kind="numeric"``
    members carry their fit ranges, ``kind="codes"`` members their code
    range; None ships the member as built."""

    stage: Any
    width: int
    up_bytes_per_row: float
    ingest: Callable[[list], dict]
    kernel: Callable[[dict, dict], torch.Tensor]
    params: dict
    descriptor: str = ""
    quant: dict | None = None

    @property
    def output_name(self) -> str:
        return self.stage.output_name


@dataclasses.dataclass
class PredictorPlan:
    """The model family's device core: ``core(plane, params)`` -> the
    [N] or [N, k] float32 core on the device, ``epilogue(core_np)`` the
    host float64 tail shared with the staged path, ``outputs_per_row`` the
    core's values per row (its download size). ``row_wise``: each row's
    core is the same function of that row alone at any row count (a GLM's
    product), so the explain lanes may share one call with the base; a
    tree core's summation order depends on the row count (the device
    route's orders), so its lanes take a call of their own, as the
    reference's program does."""

    stage: Any
    in_dim: int | None
    params: dict
    core: Callable[[torch.Tensor, dict], torch.Tensor]
    epilogue: Callable[[np.ndarray], tuple]
    outputs_per_row: int
    descriptor: str = ""
    row_wise: bool = False


# --------------------------------------------------------------------------
# plan compilation
# --------------------------------------------------------------------------
def build_fused_plan(
    plan: Sequence,
    result_names: Sequence[str],
    quantize: bool = False,
    device: torch.device | str = "cpu",
    fusion=None,
) -> "FusedServingProgram":
    """Compile the fitted serving ``plan`` into a :class:`FusedServingProgram`
    on ``device``, or raise :class:`Unfuseable` naming the obstruction.

    Fuseable shape: host prefix stages feeding one ``VectorsCombiner``
    plane (every member exposing ``fused_member_spec``), a chain of
    ``FeatureRemovalModel`` gathers, and ONE terminal predictor exposing
    ``fused_predict_spec``. ``fusion`` (the closure's FusionPlanner)
    cross-checks the members' widths against the ones it learned.

    ``quantize=True`` rewrites eligible members onto the quantized plane
    (``featurize/quantize.py``): numeric value columns go up as uint8
    codes decoded on the device (bin-aligned against a tree predictor's
    ``fused_bin_thresholds``, affine over the fit ranges otherwise), and
    code members narrow their int32 codes to the smallest integer dtype."""
    from ..models.base import PredictorModel
    from ..ops.combiner import VectorsCombiner
    from ..prep.derived_filter import FeatureRemovalModel

    plan = list(plan)
    predictors = [t for t in plan if isinstance(t, PredictorModel)]
    if len(predictors) != 1:
        raise Unfuseable(
            f"plan has {len(predictors)} predictor stages (need exactly 1)"
        )
    predictor = predictors[0]
    if plan[-1] is not predictor:
        raise Unfuseable("predictor is not the terminal stage of the plan")

    by_output = {t.output_name: t for t in plan}
    chain: list = []
    cur = by_output.get(predictor.input_names[-1]) if predictor.input_names \
        else None
    while isinstance(cur, FeatureRemovalModel):
        chain.append(cur)
        cur = by_output.get(cur.input_names[-1])
    if not isinstance(cur, VectorsCombiner):
        raise Unfuseable(
            "predictor feature plane is not a VectorsCombiner output "
            f"(found {type(cur).__name__})"
        )
    combiner = cur
    chain.reverse()

    members: list[MemberPlan] = []
    for nm in combiner.input_names:
        t = by_output.get(nm)
        spec_fn = getattr(t, "fused_member_spec", None)
        if t is None or spec_fn is None:
            raise Unfuseable(
                f"combiner member '{nm}' "
                f"({type(t).__name__ if t else 'raw'}) has no fused kernel"
            )
        members.append(spec_fn())  # may itself raise Unfuseable
    if not members:
        raise Unfuseable("combiner has no members")

    covered = {m.output_name for m in members}
    covered.add(combiner.output_name)
    covered.update(c.output_name for c in chain)
    covered.add(predictor.output_name)
    fused_stages = [t for t in plan if t.output_name in covered]
    prefix = [t for t in plan if t.output_name not in covered]
    for t in prefix:
        bad = [nm for nm in (t.input_names or ()) if nm in covered]
        if bad:
            raise Unfuseable(
                f"host stage '{t.output_name}' consumes fused "
                f"intermediate(s) {bad}"
            )
    for nm in result_names:
        if nm in covered and nm != predictor.output_name:
            raise Unfuseable(
                f"result feature '{nm}' is a fused intermediate — only the "
                "prediction leaves the device"
            )

    # widths: provable from the member specs alone; the FusionPlanner's
    # learned / primed widths cross-check them when present
    if fusion is not None:
        for m in members:
            learned = fusion.widths.get(m.stage.uid)
            if learned is not None and int(learned) != int(m.width):
                raise Unfuseable(
                    f"member '{m.output_name}' width {m.width} disagrees "
                    f"with the fusion planner's learned width {learned}"
                )
    plane_width = int(sum(m.width for m in members))
    gathers: list[np.ndarray] = []
    width = plane_width
    for c in chain:
        idx = c.fused_gather_indices()
        if idx is None:
            continue
        idx = np.asarray(idx, dtype=np.int32)
        if idx.size and (idx.min() < 0 or idx.max() >= width):
            raise Unfuseable(
                f"feature removal '{c.output_name}' keeps indices outside "
                f"[0, {width})"
            )
        gathers.append(idx)
        width = int(idx.size)

    pp_fn = getattr(predictor, "fused_predict_spec", None)
    if pp_fn is None:
        raise Unfuseable(
            f"model family {type(predictor).__name__} has no fused device "
            "predict"
        )
    pspec = pp_fn()  # may raise Unfuseable
    if pspec.in_dim is not None and int(pspec.in_dim) != width:
        raise Unfuseable(
            f"predictor expects width {pspec.in_dim}, fused plane is "
            f"{width}"
        )

    quant_plans: dict[str, Any] = {}
    quantized_members: list[str] = []
    if quantize:
        # plane columns mapped through the gathers onto the predictor's
        # inputs: a tree predictor's thresholds then give exact bin-aligned
        # codes for the value columns the removals keep
        composed = np.arange(plane_width)
        for idx in gathers:
            composed = composed[idx]
        plane_to_pred = {int(p): k for k, p in enumerate(composed)}
        thr_fn = getattr(predictor, "fused_bin_thresholds", None)
        pred_thr = thr_fn() if thr_fn is not None else None
        out_members: list[MemberPlan] = []
        off = 0
        for m in members:
            kind = (m.quant or {}).get("kind")
            if kind == "numeric":
                new_m, qp = _quantize_numeric_member(
                    m, off, plane_to_pred, pred_thr
                )
                if qp is not None:
                    quant_plans[m.output_name] = qp
                    quantized_members.append(m.output_name)
                out_members.append(new_m)
            elif kind == "codes":
                new_m, changed = _shrink_codes_member(m)
                if changed:
                    quantized_members.append(m.output_name)
                out_members.append(new_m)
            else:
                out_members.append(m)
            off += m.width
        members = out_members

    descriptor = "|".join(
        [m.descriptor or f"{type(m.stage).__name__}:{m.width}"
         for m in members]
        + [f"gather:{g.size}" for g in gathers]
        + [pspec.descriptor or type(predictor).__name__]
    )
    fingerprint = hashlib.sha1(descriptor.encode()).hexdigest()[:16]
    return FusedServingProgram(
        members=members, prefix=prefix, fused_stages=fused_stages,
        combiner=combiner, chain=chain, predictor=predictor, pspec=pspec,
        gathers=tuple(gathers), plane_width=plane_width, width=width,
        fingerprint=fingerprint, device=torch.device(device),
        quant_plans=quant_plans, quantized_members=tuple(quantized_members),
    )


def _quantize_numeric_member(member, offset, plane_to_pred, pred_thr):
    """One numeric member rewritten onto uint8 codes and a decode on the
    device. Per value column (plane column ``offset + j * stride``):
    bin-aligned codes where the gathers map it onto a predictor input with
    thresholds, affine over the fit range otherwise; a column the gathers
    drop decodes to an exact constant. ``(member, None)`` unchanged where a
    column has neither thresholds nor a fit range."""
    from ..featurize.quantize import ColumnQuant, QuantPlan, dequantize

    hint = member.quant
    n_feats = int(hint["n_feats"])
    track_nulls = bool(hint["track_nulls"])
    ranges = hint.get("ranges")
    stride = 2 if track_nulls else 1
    cols: list = []
    for j in range(n_feats):
        k = plane_to_pred.get(offset + j * stride)
        cq = None
        if k is not None and pred_thr is not None and k < pred_thr.shape[0]:
            cq = ColumnQuant.bins(pred_thr[k])
        if cq is None and ranges is not None:
            cq = ColumnQuant.affine(float(ranges[j][0]), float(ranges[j][1]))
        if cq is None and k is None:
            cq = ColumnQuant.affine(0.0, 0.0)
        if cq is None:
            return member, None
        cols.append(cq)
    qplan = QuantPlan(cols)
    orig_ingest = member.ingest
    orig_kernel = member.kernel

    def ingest(raw_cols: list) -> dict:
        d = orig_ingest(raw_cols)
        return {"codes": qplan.encode(d["vals"]), "mask": d["mask"]}

    def kernel(ing: dict, p: dict) -> torch.Tensor:
        vals = dequantize(ing["codes"], p["qreps"])
        return orig_kernel({"vals": vals, "mask": ing["mask"]}, p)

    return dataclasses.replace(
        member,
        # 1 B code + 1 B mask per feature (was 4 + 1)
        up_bytes_per_row=float(n_feats * 2),
        ingest=ingest, kernel=kernel,
        params={**member.params, "qreps": qplan.reps_table()},
        descriptor=member.descriptor + ":" + qplan.descriptor(),
        quant=None,
    ), qplan


def _shrink_codes_member(member):
    """A code member's int32 upload narrowed to the smallest integer dtype
    its code range fits; the kernel widens the codes back before the
    original kernel runs. ``(member, False)`` where int32 is needed."""
    hint = member.quant
    lo = int(hint.get("min_code", 0))
    hi = int(hint["max_code"])
    if -128 <= lo and hi <= 127:
        dt = np.int8
    elif -32768 <= lo and hi <= 32767:
        dt = np.int16
    else:
        return member, False
    itemsize = int(np.dtype(dt).itemsize)
    codes_per_row = int(hint["codes_per_row"])
    orig_ingest = member.ingest
    orig_kernel = member.kernel

    def ingest(raw_cols: list) -> dict:
        d = orig_ingest(raw_cols)
        d["codes"] = d["codes"].astype(dt)
        return d

    def kernel(ing: dict, p: dict) -> torch.Tensor:
        return orig_kernel({**ing, "codes": ing["codes"].int()}, p)

    return dataclasses.replace(
        member,
        up_bytes_per_row=float(
            member.up_bytes_per_row - codes_per_row * (4 - itemsize)
        ),
        ingest=ingest, kernel=kernel,
        descriptor=member.descriptor + f":qi{8 * itemsize}",
        quant=None,
    ), True


class FusedServingProgram:
    """A compiled fused serving plan on one device. Thread-safe: the
    device params are uploaded once under a lock, and each batch takes its
    own staging buffer."""

    def __init__(
        self, members, prefix, fused_stages, combiner, chain, predictor,
        pspec, gathers, plane_width, width, fingerprint, device,
        quant_plans=None, quantized_members=(),
    ):
        self.members = members
        self.prefix = prefix
        self.fused_stages = fused_stages
        self.combiner = combiner
        self.chain = chain
        self.predictor = predictor
        self.pspec = pspec
        self.gathers = gathers
        self.plane_width = plane_width
        self.width = width
        self.fingerprint = fingerprint
        self.device = device
        #: member output -> QuantPlan (numeric members on uint8 codes);
        #: code-narrowed members appear in quantized_members without one
        self.quant_plans = dict(quant_plans or {})
        self.quantized_members = tuple(quantized_members)
        self.quantized = bool(self.quantized_members)
        self.covered = frozenset(t.output_name for t in fused_stages)
        self.up_bytes_per_row = float(
            sum(m.up_bytes_per_row for m in members)
        )
        #: the core is float32
        self.down_bytes_per_row = float(4 * pspec.outputs_per_row)
        self._params_dev = None
        self._params_lock = threading.Lock()
        self._staging = StagingPool(self.device)

    # ------------------------------------------------------------- reporting
    def describe(self) -> dict[str, Any]:
        out = {
            "fingerprint": self.fingerprint,
            "members": [
                {"stage": m.stage.operation_name, "output": m.output_name,
                 "width": int(m.width)}
                for m in self.members
            ],
            "planeWidth": self.plane_width,
            "predictorWidth": self.width,
            "gathers": [int(g.size) for g in self.gathers],
            "upBytesPerRow": self.up_bytes_per_row,
            "downBytesPerRow": self.down_bytes_per_row,
            "coveredStages": sorted(self.covered),
            "hostPrefixStages": [t.output_name for t in self.prefix],
            "quantized": self.quantized,
        }
        if self.quantized:
            out["quantizedMembers"] = list(self.quantized_members)
            # per-column largest reconstruction error (0.0 for bin-aligned
            # and constant columns: predictions cannot move)
            out["quantError"] = {
                nm: qp.errors() for nm, qp in self.quant_plans.items()
            }
            out["quantPlans"] = {
                nm: qp.to_json() for nm, qp in self.quant_plans.items()
            }
        return out

    # ------------------------------------------------------------- dispatch
    def _device_params(self) -> dict:
        """The fit-static params on the device, uploaded once, at the
        program's first batch (a tree model's stacks are on the device
        already, in its own state)."""
        with self._params_lock:
            if self._params_dev is None:
                def up(tree):
                    if isinstance(tree, dict):
                        return {k: up(v) for k, v in tree.items()}
                    return torch.from_numpy(np.array(tree)).to(self.device)

                self._params_dev = {
                    "members": [up(m.params) for m in self.members],
                    "gathers": [
                        up(g.astype(np.int64)) for g in self.gathers
                    ],
                    "predictor": up(self.pspec.params),
                }
            return self._params_dev

    def assemble(self, ingest: list[dict], params: dict) -> torch.Tensor:
        """The members' blocks rebuilt on the device and concatenated."""
        blocks = [m.kernel(ing, p) for m, ing, p in
                  zip(self.members, ingest, params["members"])]
        return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)

    def gather(self, plane: torch.Tensor, params: dict) -> torch.Tensor:
        """The SanityChecker's keep-index gathers, in order."""
        for idx in params["gathers"]:
            plane = torch.index_select(plane, 1, idx)
        return plane

    @property
    def predictor_input_meta(self):
        """The fit-static VectorMetadata of the plane the predictor reads
        (what ``explain=k`` groups by), or None where none is recoverable."""
        producer = self.chain[-1] if self.chain else self.combiner
        for attr in ("_meta_cache", "_flatten_cache"):
            cached = getattr(producer, attr, None)
            if cached is not None and getattr(cached[1], "columns", None) is not None:
                return cached[1]
        meta = getattr(producer, "new_metadata", None)
        if meta is not None and getattr(meta, "columns", None) is not None:
            return meta
        return None

    def run(self, cols: dict, b: int, n: int) -> tuple[np.ndarray, dict]:
        """The program over already-built raw columns of ``b`` rows (``n``
        real, the rest copies of row 0). Returns ``(core, info)``: the
        host core of the ``n`` real rows, and the batch's transfers, one
        upload (the ingest arrays, in one buffer) and one download (the
        core). Raises :class:`Unfuseable` from an ingest (the text cap)
        before anything is uploaded."""
        core, _, info = self._run(cols, b, n, None)
        return core, info

    def run_explain(self, cols: dict, b: int, n: int, lane_masks: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray, dict]:
        """``run`` with the LOCO lanes of ``explain=k``: lane ``g`` is the
        plane with the columns of ``lane_masks[g]`` zeroed on the device
        (``torch.where``: exact zeros, as the staged sweep makes them), and
        the base core and every lane core come from one run of launches.
        The masks go up in the ingest's buffer and the lane cores come
        down with the base core: still one upload and one download.
        Returns ``(core [n, ...], lane_core [lanes * n, ...], info)``, the
        real rows of each lane."""
        return self._run(cols, b, n, lane_masks)

    def _run(self, cols, b, n, lane_masks):
        params = self._device_params()
        ingest = [m.ingest([cols[nm] for nm in m.stage.input_names])
                  for m in self.members]
        keys = [sorted(d) for d in ingest]
        arrays = [d[k] for d, ks in zip(ingest, keys) for k in ks]
        if any(a.shape[0] != b for a in arrays):
            raise ValueError(f"fused ingest: expected {b} rows")
        lanes = 0
        if lane_masks is not None:
            lane_masks = np.ascontiguousarray(lane_masks, dtype=np.float32)
            lanes = int(lane_masks.shape[0])
            arrays = arrays + [lane_masks]
        from ..telemetry import runlog, spans

        buf = self._staging.acquire(arrays)
        t0 = spans.clock()
        views = list(buf.upload(arrays))
        runlog.record_upload(buf.nbytes, spans.clock() - t0)
        it = iter(views)
        dev_ingest = [{k: next(it) for k in ks} for ks in keys]
        plane = self.gather(self.assemble(dev_ingest, params), params)
        if lanes:
            masks = views[-1]
            zero = torch.zeros((), dtype=plane.dtype, device=plane.device)
            lane_planes = torch.where(masks[:, None, :] > 0, zero,
                                      plane[None, :, :])
            if self.pspec.row_wise:
                # one product over the base and every lane: a row whose
                # zeroed columns carry no weight gets the base's bits, so
                # its contribution is exactly 0, as on the reference's
                # CPU; two products of different row counts may block
                # their sums differently on the card
                both = torch.cat([plane[None], lane_planes]).reshape(
                    (lanes + 1) * b, plane.shape[1])
                out = self.pspec.core(both, params["predictor"])
            else:
                core = self.pspec.core(plane, params["predictor"])
                lane_core = self.pspec.core(
                    lane_planes.reshape(lanes * b, plane.shape[1]),
                    params["predictor"])
                out = torch.cat([core, lane_core])
            out = out.reshape(lanes + 1, b, *out.shape[1:])[:, :n]
        else:
            out = self.pspec.core(plane, params["predictor"])[:n]
        t0 = spans.clock()
        host = out.cpu().numpy()
        runlog.record_download(host.nbytes, spans.clock() - t0)
        self._staging.release(buf)
        info = {
            "uploads": 1, "downloads": 1, "lanes": lanes,
            "upBytes": int(buf.nbytes), "downBytes": int(host.nbytes),
        }
        if not lanes:
            return host, None, info
        tail = host.shape[2:]
        return host[0], host[1:].reshape(lanes * n, *tail), info

    def epilogue(self, core: np.ndarray) -> tuple:
        """The host float64 tail mapping the downloaded core to
        ``(prediction, probability, raw)``: the staged path's own
        ``predictions_from_core``."""
        return self.pspec.epilogue(core)


# --------------------------------------------------------------------------
# member plans (built by the stages' fused_member_spec)
# --------------------------------------------------------------------------
def numeric_member(
    stage, fills: np.ndarray, track_nulls: bool, ranges=None
) -> MemberPlan:
    """Impute and null-track on the device. Ingest: float32 values and the
    validity mask; ``where(mask, value, fill)`` in float32 equals the
    staged float64 block once it lands in the float32 plane. ``ranges``
    (per-column fit-time [lo, hi]) is the quantized plane's hint."""
    fills = np.asarray(fills, dtype=np.float32)
    n_feats = int(fills.shape[0])
    width = n_feats * (2 if track_nulls else 1)

    def ingest(cols: list) -> dict:
        vals = np.stack(
            [np.asarray(c.values, dtype=np.float32) for c in cols], axis=1
        )
        mask = np.stack([np.asarray(c.mask, dtype=bool) for c in cols], axis=1)
        return {"vals": vals, "mask": mask}

    def kernel(ing: dict, p: dict) -> torch.Tensor:
        vals = torch.where(ing["mask"], ing["vals"], p["fills"][None, :])
        if not track_nulls:
            return vals
        nulls = (~ing["mask"]).to(torch.float32)
        # the staged layout interleaves [value, null] per feature
        return torch.stack([vals, nulls], dim=2).reshape(vals.shape[0], width)

    return MemberPlan(
        stage=stage, width=width,
        up_bytes_per_row=float(n_feats * (4 + 1)),
        ingest=ingest, kernel=kernel, params={"fills": fills},
        descriptor=f"numeric:{n_feats}:{'nulls' if track_nulls else 'plain'}",
        quant={
            "kind": "numeric", "n_feats": n_feats,
            "track_nulls": track_nulls, "ranges": ranges,
        },
    )


def passthrough_member(stage, n_feats: int) -> MemberPlan:
    """RealNN passthrough columns (no nulls possible)."""

    def ingest(cols: list) -> dict:
        return {"vals": np.stack(
            [np.asarray(c.values, dtype=np.float32) for c in cols], axis=1)}

    def kernel(ing: dict, p: dict) -> torch.Tensor:
        return ing["vals"]

    return MemberPlan(
        stage=stage, width=n_feats, up_bytes_per_row=float(4 * n_feats),
        ingest=ingest, kernel=kernel, params={},
        descriptor=f"passthrough:{n_feats}",
    )


def onehot_member(stage, vocabs, track_nulls, clean_text) -> MemberPlan:
    """The pivot one-hot as a scatter on the device: the host resolves each
    distinct raw value to a code once (``pivot_codes``: -1 null, -2 OTHER,
    >= 0 vocabulary column), and the device puts a 1 in each row's column
    of each feature's block [vocab..., OTHER(, null)], as the staged
    ``pivot_block`` does. Set-valued pivots are refused by the caller."""
    from ..ops.categorical import pivot_codes
    from ..types.columns import TextColumn

    widths = [len(v) + 1 + (1 if track_nulls else 0) for v in vocabs]
    indexes = [{v: i for i, v in enumerate(vocab)} for vocab in vocabs]
    total = int(sum(widths))
    n_feats = len(vocabs)
    offsets = np.cumsum([0] + widths[:-1]).astype(np.int64)
    other = np.asarray([len(v) for v in vocabs], dtype=np.int64)
    # a null lands in its null column, or (untracked) in the dump column
    null = other + 1 if track_nulls else np.full(n_feats, -1, np.int64)

    def ingest(cols: list) -> dict:
        codes = np.empty((len(cols[0]), n_feats), dtype=np.int32)
        for j, (c, index) in enumerate(zip(cols, indexes)):
            if not isinstance(c, TextColumn):
                raise Unfuseable(
                    f"pivot member expected a text column, got "
                    f"{type(c).__name__}"
                )
            codes[:, j] = pivot_codes(c.values, index, clean_text)
        return {"codes": codes}

    def kernel(ing: dict, p: dict) -> torch.Tensor:
        codes = ing["codes"].long()
        col = torch.where(codes >= 0, codes,
                          torch.where(codes == -2, p["other"], p["null"]))
        # column `total` is the dump column of untracked nulls
        col = torch.where(col >= 0, col + p["offsets"], total)
        out = torch.zeros((codes.shape[0], total + 1), dtype=torch.float32,
                          device=codes.device)
        out.scatter_(1, col, 1.0)
        return out[:, :total]

    return MemberPlan(
        stage=stage, width=total, up_bytes_per_row=float(4 * n_feats),
        ingest=ingest, kernel=kernel,
        params={"offsets": offsets, "other": other, "null": null},
        descriptor=(
            "onehot:" + ",".join(map(str, widths))
            + (":nulls" if track_nulls else "")
        ),
        quant={
            "kind": "codes", "min_code": -2,
            "max_code": max(len(v) for v in vocabs) - 1,
            "codes_per_row": n_feats,
        },
    )


def _text_pairs(values, num_hashes: int, binary: bool, to_lowercase: bool,
                min_token_length: int, seed: int):
    """int64 (rows, buckets) of a text column's tokens: the native COO
    pass, or the Python tokenizer and the batch hash (deduplicated per row
    under ``binary``, as the native pass does)."""
    from .. import native
    from ..ops import text as text_ops
    from ..utils import text as text_util

    texts, rows_idx = text_ops._partition_nulls(values)
    if not texts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    coo = native.tokenize_hash_coo(
        texts, rows_idx, num_hashes, seed=seed, binary=binary,
        to_lowercase=to_lowercase, min_token_length=min_token_length,
    )
    if coo is not None:
        return coo[0].astype(np.int64), coo[1].astype(np.int64)
    r_parts, c_parts = [], []
    for raw, row in zip(texts, rows_idx.tolist()):
        toks = text_util.tokenize(raw, to_lowercase=to_lowercase,
                                  min_token_length=min_token_length)
        if not toks:
            continue
        j = (native.murmur3_batch(toks, seed=seed)
             % np.uint32(num_hashes)).astype(np.int64)
        if binary:
            j = np.unique(j)
        r_parts.append(np.full(j.shape[0], row, dtype=np.int64))
        c_parts.append(j)
    if not r_parts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(r_parts), np.concatenate(c_parts)


def hashed_text_member(
    stage, methods, num_hashes: int, track_nulls: bool, binary_freq: bool,
    to_lowercase: bool, min_token_length: int, seed: int,
) -> MemberPlan:
    """HashingTF text blocks as a scatter on the device. The host stays a
    codec: each row's tokens are hashed by the staged route itself
    (``ops.text.row_tokens``, ``token_buckets``) and collapsed to at most
    ``TPTPU_TEXT_FUSED_TOKENS`` (default 16) distinct buckets per row and
    slot, as int32 codes with float32 occurrence counts; the device
    scatters them into the ``num_hashes``-wide block. The (row, bucket)
    pairs come from the native COO pass (``native.tokenize_hash_coo``);
    a column with non-ASCII rows (or the native routes disabled) takes the
    Python tokenizer and the batch hash, as in the reference. Binary term frequency
    applies ``> 0`` after the scatter. A row with more distinct buckets
    than the cap raises :class:`Unfuseable` at ingest (the batch goes
    staged, counted). Ignore slots contribute their null indicator; Pivot
    slots are refused."""
    from ..ops import text as text_ops

    hash_slots = [i for i, m in enumerate(methods) if m == text_ops.HASH]
    if not hash_slots:
        raise Unfuseable("smart-text member has no hashed slots")
    if any(m == text_ops.PIVOT for m in methods):
        raise Unfuseable(
            "smart-text member mixes Pivot and Hash slots — not fuseable"
        )
    n_slots = len(methods)
    n_hash = len(hash_slots)
    k_cap = int(os.environ.get("TPTPU_TEXT_FUSED_TOKENS", "16"))
    widths = [
        (num_hashes if m == text_ops.HASH else 0) + (1 if track_nulls else 0)
        for m in methods
    ]
    total = int(sum(widths))
    if total <= 0:
        raise Unfuseable("smart-text member has zero fused width")

    def slot_codes(values, n: int):
        """One slot's (codes [n, k_cap] int32, counts [n, k_cap] float32);
        the sentinel code ``num_hashes`` is a dump column sliced off after
        the scatter."""
        rows, hcols = _text_pairs(
            values, num_hashes, binary_freq, to_lowercase, min_token_length,
            seed,
        )
        codes = np.full((n, k_cap), num_hashes, dtype=np.int32)
        weights = np.zeros((n, k_cap), dtype=np.float32)
        if rows.size:
            # duplicate (row, bucket) pairs collapse to one slot with their
            # count; the rank within a row from the sorted row runs
            pair = rows * np.int64(num_hashes) + hcols
            uniq, counts = np.unique(pair, return_counts=True)
            ur = uniq // np.int64(num_hashes)
            uc = uniq % np.int64(num_hashes)
            pos = np.arange(uniq.size) - np.searchsorted(ur, ur)
            k_max = int(pos.max()) + 1
            if k_max > k_cap:
                raise Unfuseable(
                    f"text row needs {k_max} distinct hash buckets "
                    f"(> TPTPU_TEXT_FUSED_TOKENS={k_cap})"
                )
            codes[ur, pos] = uc.astype(np.int32)
            weights[ur, pos] = counts.astype(np.float32)
        return codes, weights

    def ingest(cols: list) -> dict:
        n = len(cols[0])
        codes = np.empty((n, n_hash, k_cap), dtype=np.int32)
        weights = np.empty((n, n_hash, k_cap), dtype=np.float32)
        nulls = np.zeros((n, n_slots), dtype=np.uint8)
        hs = 0
        for s, c in enumerate(cols):
            nulls[:, s] = [v is None for v in c.values]
            if methods[s] == text_ops.HASH:
                codes[:, hs], weights[:, hs] = slot_codes(c.values, n)
                hs += 1
        out = {"codes": codes, "weights": weights}
        if track_nulls:
            out["nulls"] = nulls
        return out

    def kernel(ing: dict, p: dict) -> torch.Tensor:
        codes = ing["codes"].long()
        n = codes.shape[0]
        blocks = []
        hs = 0
        for s in range(n_slots):
            if methods[s] == text_ops.HASH:
                acc = torch.zeros((n, num_hashes + 1), dtype=torch.float32,
                                  device=codes.device)
                acc.scatter_add_(1, codes[:, hs], ing["weights"][:, hs])
                block = acc[:, :num_hashes]
                if binary_freq:
                    block = (block > 0).to(torch.float32)
                blocks.append(block)
                hs += 1
            if track_nulls:
                blocks.append(ing["nulls"][:, s:s + 1].to(torch.float32))
        return blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)

    return MemberPlan(
        stage=stage, width=total,
        up_bytes_per_row=float(
            n_hash * k_cap * 8 + (n_slots if track_nulls else 0)
        ),
        ingest=ingest, kernel=kernel, params={},
        descriptor=(
            f"hashtext:{num_hashes}x{n_hash}:k{k_cap}"
            + (":bin" if binary_freq else "")
            + (":nulls" if track_nulls else "")
        ),
        quant={
            "kind": "codes", "min_code": 0, "max_code": num_hashes,
            "codes_per_row": n_hash * k_cap,
        },
    )
