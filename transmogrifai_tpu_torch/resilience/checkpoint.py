"""Layer-wise training checkpoints + CV candidate checkpoints.

Layout under one checkpoint root::

    <root>/layers/layer-000/     one dir per completed DAG layer, written
        manifest.json            atomically (temp dir + os.rename) in the
        arrays.npz               manifest+npz format of workflow/persistence
    <root>/cv/<candidate>.json   per-candidate sweep results (atomic file)

A layer dir only ever appears complete: the writer fills a ``.tmp-<pid>``
sibling and renames it into place, so a kill mid-write leaves a temp dir
the next run ignores. ``load_layers`` restores the longest contiguous
prefix of layers whose DAG signature matches the live workflow — anything
missing, torn, stale, or unreadable simply truncates the prefix and is
refit (corruption is a warning, never a crash).

Checkpointed stages are rebuilt via the persistence registry
(``construct_stage``) and rewired to the *live* DAG's features, so a
resumed ``fit_and_transform_dag`` sees them as a ``prefitted`` dict —
exactly the existing warm-start seam. A restored stage is placed on the
device of the live estimator it stands in for (``None`` means the card),
so a resumed model scores where the uninterrupted one would; a stage
holding CUDA tensors is downloaded by ``persistence.stage_to_entry``,
which records the bytes on the run ledger's transfer census.

The DAG signature leaves a stage's ``device`` parameter out, so a
checkpoint does not depend on where it was written. The saved arrays are
host numpy; the manifest's ``mesh`` field is written as ``null`` until
distributed resilience (``ROADMAP.md`` A13b) records a topology and
reshards on a topology change, and the sharded layout's load hook
(``FaultPlan.on_shard_load``) waits for it too.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from typing import Any, Sequence

import numpy as np

log = logging.getLogger(__name__)

_LAYER_FMT = "layer-{:03d}"


class CheckpointError(RuntimeError):
    """A checkpoint member is missing, torn, or stale."""


class CheckpointMeshMismatch(CheckpointError):
    """A layer checkpoint written under another device topology than the
    resuming run's mesh, under a strict layout policy: distributed
    resilience's check (``ROADMAP.md`` A13b). The port's checkpoints record no
    mesh, so nothing raises it yet."""


def dag_signature(layers: Sequence[Sequence[Any]], data_token: str = "") -> str:
    """Fingerprint of the run a checkpoint is valid for: per layer, each
    stage's class, operation name, arity, AND constructor params, in order,
    plus a token for the training data. Deliberately uid-free (uids come
    from a process-global counter, so they shift if a restarted script
    builds anything extra before the workflow) — stages are matched back by
    (layer, position) instead. A resumed run with a different signature
    (edited pipeline, changed hyperparameters, different input data, RFF
    dropped different features) refits from scratch rather than restoring
    stale stages."""
    h = hashlib.sha256()
    h.update(data_token.encode())
    for layer in layers:
        for s in layer:
            try:
                params = json.dumps(
                    {k: v for k, v in s.get_params().items()
                     if k != "device"},
                    sort_keys=True, default=str,
                )
            except Exception:
                params = "?"
            h.update(
                f"{type(s).__name__}|{s.operation_name}"
                f"|{len(s.input_features)}|{params};".encode()
            )
        h.update(b"/")
    return h.hexdigest()[:16]


def update_array_sample(h: Any, arr: np.ndarray, k: int = 4096) -> None:
    """Feed a bounded content sample of ``arr`` into hash ``h``: shape/dtype
    header, full bytes when small, else head + tail + a strided middle
    sample — O(k) work and allocation regardless of array size. The one
    sampling scheme shared by every resilience fingerprint (layer/CV), so
    the schemes cannot drift apart."""
    a = np.ascontiguousarray(arr)
    h.update(f"{a.shape}|{a.dtype}".encode())
    if a.nbytes <= 1 << 20:
        h.update(a.tobytes())
        return
    flat = a.reshape(-1)
    h.update(flat[:k].tobytes())
    h.update(flat[-k:].tobytes())
    step = max(1, len(flat) // k)
    h.update(np.ascontiguousarray(flat[::step][:k]).tobytes())


def dataset_fingerprint(dataset: Any) -> str:
    """Cheap content token for the training Dataset: row count, column
    names, and head/tail/strided samples of each column's value plane —
    O(columns), never a full-data scan. Rides the DAG signature so layer
    checkpoints fitted on one dataset are never restored against another."""
    h = hashlib.sha256()
    h.update(str(dataset.num_rows).encode())
    for name in sorted(dataset.columns):
        col = dataset[name]
        h.update(name.encode())
        values = getattr(col, "values", None)
        if values is None:
            continue
        arr = np.asarray(values) if not isinstance(values, list) else None
        if arr is not None and arr.dtype != object:
            update_array_sample(h, arr, k=1024)
        else:
            rows = values if isinstance(values, list) else arr.tolist()
            sample = rows[:64] + rows[-64:] if len(rows) > 128 else rows
            # set/dict reprs are hash-ordered (varies across processes) —
            # canonicalize so the token is restart-stable
            sample = [
                sorted(v) if isinstance(v, (set, frozenset))
                else sorted(v.items()) if isinstance(v, dict)
                else v
                for v in sample
            ]
            h.update(repr(sample).encode())
    return h.hexdigest()[:16]


def _live_device(live: Any):
    """The device the live estimator fits on, where its fitted stage must
    come back (``None`` means the card; a model selector's candidates carry
    the device)."""
    from ..utils.device import resolve_device

    if hasattr(live, "device"):
        return resolve_device(live.device)
    models = getattr(live, "models", None)
    if models:
        return resolve_device(getattr(models[0][0], "device", None))
    return resolve_device("cpu")


class CheckpointManager:
    def __init__(self, root: str):
        self.root = root
        self.layers_dir = os.path.join(root, "layers")
        self.cv_dir = os.path.join(root, "cv")
        os.makedirs(self.layers_dir, exist_ok=True)
        os.makedirs(self.cv_dir, exist_ok=True)

    def clear(self) -> None:
        """Drop every layer and CV checkpoint — fresh-train semantics. A
        new run reusing the directory must not leave older-generation
        entries behind that a later crash + resume could stitch together
        with its own layers into a franken-model."""
        for d in (self.layers_dir, self.cv_dir):
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d, exist_ok=True)
        try:
            os.remove(self.stream_cursor_path())
        except OSError:
            pass

    # ---------------------------------------------------------- layer side
    def layer_path(self, index: int) -> str:
        return os.path.join(self.layers_dir, _LAYER_FMT.format(index))

    def has_layer(self, index: int) -> bool:
        return os.path.isdir(self.layer_path(index))

    def save_layer(
        self,
        index: int,
        signature: str,
        fitted_stages: Sequence[tuple[int, str, Any]],
    ) -> None:
        """Atomically persist one layer's fitted stages as
        ``(position_in_layer, estimator_uid, fitted_stage)`` triples — the
        position is the restore identity (uids are process-local). Layers
        with no estimators still write an (empty) manifest so the completed
        prefix stays contiguous."""
        from ..workflow.persistence import atomic_write_model_dir, stage_to_entry

        arrays: dict[str, np.ndarray] = {}
        entries = []
        for pos, est_uid, stage in fitted_stages:
            entry = stage_to_entry(est_uid, stage, arrays)
            entry["position"] = pos
            entries.append(entry)
        manifest = {
            "version": 1,
            "layer": index,
            "dagSignature": signature,
            "mesh": None,
            "stages": entries,
        }
        atomic_write_model_dir(self.layer_path(index), manifest, arrays)
        from ..telemetry import events as _tevents

        _tevents.emit("checkpoint_save", layer=index, stages=len(entries))
        log.debug("checkpointed layer %d (%d stages)", index, len(entries))

    def load_layers(
        self,
        signature: str,
        layers: Sequence[Sequence[Any]],
    ) -> dict[str, Any]:
        """Restore the longest contiguous prefix of valid layer checkpoints
        as a ``prefitted`` dict keyed by the LIVE estimator uid — entries
        match live stages by (layer, position), so resume survives a
        restarted process whose uid counter drifted."""
        prefitted: dict[str, Any] = {}
        index = 0
        while index < len(layers):
            d = self.layer_path(index)
            if not os.path.isdir(d):
                break
            try:
                prefitted.update(
                    self._load_layer(d, signature, layers[index])
                )
            except Exception as e:
                log.warning(
                    "checkpoint layer %d unusable (%s); refitting from "
                    "layer %d", index, e, index,
                )
                # the torn/stale dir would only shadow the re-save
                shutil.rmtree(d, ignore_errors=True)
                break
            index += 1
        if index:
            log.info(
                "resume: restored %d fitted stages from %d checkpointed "
                "layers", len(prefitted), index,
            )
        return prefitted

    def _load_layer(
        self, d: str, signature: str, live_layer: Sequence[Any],
    ) -> dict[str, Any]:
        from ..workflow.persistence import (
            construct_stage_checked,
            stage_arrays_from_npz,
        )

        manifest_path = os.path.join(d, "manifest.json")
        try:
            with open(manifest_path) as fh:
                manifest = json.load(fh)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointError(f"manifest.json unreadable: {e}") from e
        if manifest.get("dagSignature") != signature:
            raise CheckpointError(
                f"stale DAG signature {manifest.get('dagSignature')!r} "
                f"(live DAG is {signature!r})"
            )
        npz_path = os.path.join(d, "arrays.npz")
        try:
            npz = np.load(npz_path, allow_pickle=False)
        except Exception as e:
            raise CheckpointError(f"arrays.npz unreadable: {e}") from e
        out: dict[str, Any] = {}
        for entry in manifest["stages"]:
            pos = entry.get("position")
            if pos is None or not (0 <= pos < len(live_layer)):
                raise CheckpointError(
                    f"checkpointed stage {entry['uid']} has no matching "
                    f"position {pos} in the live layer"
                )
            live = live_layer[pos]
            if entry["operationName"] != live.operation_name:
                raise CheckpointError(
                    f"position {pos} holds {live.operation_name!r} live but "
                    f"{entry['operationName']!r} in the checkpoint"
                )
            arrays = stage_arrays_from_npz(npz, entry["uid"], npz_path)
            stage = construct_stage_checked(entry, arrays, npz_path)
            stage.uid = entry["uid"]
            stage.operation_name = entry["operationName"]
            stage.metadata = entry.get("metadata", {})
            if hasattr(stage, "parent_uid"):
                stage.parent_uid = live.uid
            # rewire to the LIVE graph: input features, output name, and
            # the prefitted key all come from the live stage at this
            # position, so the restored model slots into the current DAG
            # even when uids drifted across processes
            stage.input_features = tuple(live.input_features)
            stage._fixed_output_name = live.output_name
            stage.to(_live_device(live))
            out[live.uid] = stage
        return out

    # ------------------------------------------------------- stream cursor
    def stream_cursor_path(self) -> str:
        return os.path.join(self.root, "stream_cursor.json")

    def save_stream_cursor(self, payload: dict[str, Any]) -> None:
        """Persist the out-of-core ingest cursor (workflow/stream.py):
        chunks folded so far + the reducer/buffer state snapshot, written
        atomically (temp + rename) like every other checkpoint member, so
        a kill mid-write leaves the previous cursor intact and a resume
        never stitches a torn one."""
        path = self.stream_cursor_path()
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(payload, fh)
        os.replace(tmp, path)

    def load_stream_cursor(self, signature: str) -> dict[str, Any] | None:
        """The last persisted stream cursor, or None when missing, torn,
        or written for a different raw-feature schema / chunk source
        (``signature`` mismatch — a changed pipeline must re-ingest from
        chunk 0, not resume into the wrong reducer state)."""
        path = self.stream_cursor_path()
        try:
            with open(path) as fh:
                cur = json.load(fh)
        except FileNotFoundError:
            return None
        except (OSError, json.JSONDecodeError) as e:
            log.warning("stream cursor %s unusable (%s); re-ingesting", path, e)
            return None
        if cur.get("signature") != signature:
            log.warning(
                "stream cursor signature mismatch (%s != %s); re-ingesting",
                cur.get("signature"), signature,
            )
            return None
        return cur

    # ------------------------------------------------------------- CV side
    def candidate_path(self, key: str) -> str:
        return os.path.join(self.cv_dir, f"{key}.json")

    def save_candidate(self, key: str, payload: dict[str, Any]) -> None:
        from ..workflow.persistence import _json_default

        path = self.candidate_path(key)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as fh:
            json.dump(payload, fh, default=_json_default)
        os.replace(tmp, path)

    def load_candidate(self, key: str) -> dict[str, Any] | None:
        path = self.candidate_path(key)
        try:
            with open(path) as fh:
                return json.load(fh)
        except FileNotFoundError:
            return None
        except (OSError, json.JSONDecodeError) as e:
            log.warning("CV checkpoint %s unusable (%s); re-running", key, e)
            try:
                os.remove(path)
            except OSError:
                pass
            return None
