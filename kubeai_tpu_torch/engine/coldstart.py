"""Engine cold start: snapshot restore-first boots and their phase
timings. Counterpart of kubeai_tpu/engine/coldstart.py.

  1. `ColdStartManager.acquire_params` asks the `SnapshotStore`
     (kubeai_tpu_torch/objstore.py) for a snapshot keyed by (model,
     engine-config fingerprint, device signature, snapshot version).
     Hit → chunk-parallel fetch, the kernel library put in place
     (ops/_build.py) so the first launch runs no `nvcc`, and the native
     checkpoint restored onto the device. Miss or `SnapshotMismatch`
     (NEVER serve a stale layout) → the full load path, unchanged.
  2. After warm-up, `maybe_publish` writes the snapshot back on a
     full-load boot: the tree `load` handed the engine (quantized, with
     `--quantization int8`) and the library the boot built or found.
     The next replica of this exact configuration restores.

Two parts stand in for JAX parts: `device_signature` for the device
half of the key (a tag of the port, the torch and CUDA versions, the
card's compute capability and count, the kernel library's hash), so a
port boot and a JAX boot never share a fingerprint (a rank of a mesh
adds `mesh_signature`, the JAX package's mesh half); and the kernel library
for the JAX persistent compilation cache. The CUDA graphs are captured
when the engine is built and are not in a snapshot: a restored boot's
`compile` phase still captures them.

Every boot is phase-timed into `ColdStartTracker` (`fetch` / `restore`
on the snapshot path, `load` for the checkpoint on the full path,
`compile` for the engine's construction, where the CUDA graphs are
captured, and its first generate, where the kernels are built or
loaded; `warmup` for the second generate), exported as
`kubeai_coldstart_*` metrics and on `/v1/state`, so the fleet's planner
can price a replica's measured cold-start cost.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import shutil
import tempfile
import time

import torch

from kubeai_tpu_torch.device import resolve_device
from kubeai_tpu_torch.engine.weights import (
    load_native_checkpoint,
    save_native_checkpoint,
)
from kubeai_tpu_torch.objstore import SnapshotMismatch, SnapshotStore
from kubeai_tpu_torch.ops import _build

logger = logging.getLogger(__name__)

# Phase vocabulary, as in the JAX package.
PHASES = ("fetch", "restore", "load", "compile", "warmup")

# Snapshot events exported with counter semantics.
EVENTS = ("restored", "published", "mismatch", "absent", "error")

# The first entry of every device signature: no JAX snapshot key can
# equal a port one.
PORT_TAG = "kubeai_tpu_torch"

class ColdStartTracker:
    """Per-phase wall timings for one engine boot (injectable clock so
    the fake-clock sim drives it deterministically)."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._t0 = clock()
        self._total: float | None = None
        self.phases: dict[str, float] = {}
        self.events: list[str] = []
        self.restored = False
        self.fingerprint = ""

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = self._clock()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                self._clock() - t0
            )

    def event(self, name: str) -> None:
        self.events.append(name)

    def finish(self) -> float:
        self._total = self._clock() - self._t0
        return self._total

    @property
    def total_s(self) -> float:
        return self._total if self._total is not None else (
            self._clock() - self._t0
        )

    def snapshot(self) -> dict:
        """The `/v1/state` cold_start block (and the metric source)."""
        return {
            "restored": self.restored,
            "fingerprint": self.fingerprint,
            "phases": dict(self.phases),
            "total_s": round(self.total_s, 6),
            "events": list(self.events),
        }


def mesh_signature(mesh, rank: int) -> list:
    """The mesh half of the key, as the JAX package's `mesh_signature`:
    the mesh's axis sizes, and the rank, whose shard the snapshot holds
    (each rank acquires and publishes its own). Any change misses: a tree
    sharded for another slice, or another rank's shard, is a stale
    layout, and a mesh-free boot's snapshot never restores into a rank."""
    names = mesh.mesh_dim_names
    return [f"{n}={mesh.size(i)}" for i, n in enumerate(names)] + [f"rank={rank}"]


def device_signature(device) -> list:
    """The device half of the snapshot key, where the JAX package puts
    its mesh shape: the port's tag, the torch and CUDA versions, the
    device type, the card's compute capability and the device count on
    CUDA, and the hash of the kernel sources and flags (the library a
    snapshot carries is built for that hash; a change of sources misses
    and republishes)."""
    dev = torch.device(device)
    sig = [PORT_TAG, f"torch={torch.__version__}", f"cuda={torch.version.cuda}",
           f"device={dev.type}"]
    if dev.type == "cuda":
        major, minor = torch.cuda.get_device_capability(dev)
        sig += [f"capability={major}.{minor}", f"count={torch.cuda.device_count()}"]
    sig.append(f"kernels={_build.build_dir().name}")
    return sig


class ColdStartManager:
    """Restore-first boot orchestration for `engine/server.py::main`.

    With no snapshot URL the manager degrades to a pure phase timer
    around the full load path — `/v1/state` and the coldstart metrics
    stay populated either way. `device` is where a restore puts the
    tree (default cuda, raising without a card). `mesh_sig` (a rank of a
    mesh: `mesh_signature`) joins the key."""

    def __init__(
        self,
        snapshot_url: str,
        model_name: str,
        engine_config,
        device=None,
        *,
        work_dir: str | None = None,
        clock=time.monotonic,
        store=None,
        publish: bool = True,
        mesh_sig: list | None = None,
    ):
        self.enabled = bool(snapshot_url)
        # publish=False boots are restore-only consumers (CRD
        # coldStart.publish): they never write a snapshot back.
        self.publish = publish
        self.model = model_name
        self.device = resolve_device(device)
        self.tracker = ColdStartTracker(clock)
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="kubeai-snap-")
        self.params_dir = os.path.join(self.work_dir, "params")
        self.kernels_dir = os.path.join(self.work_dir, "kernels")
        cfg = (
            dataclasses.asdict(engine_config)
            if dataclasses.is_dataclass(engine_config)
            else dict(engine_config or {})
        )
        self.fingerprint = SnapshotStore.fingerprint(
            model_name, cfg, device_signature(self.device) + list(mesh_sig or [])
        )
        self.tracker.fingerprint = self.fingerprint
        self.store = store or (
            SnapshotStore(snapshot_url) if self.enabled else None
        )
        # The library put in place by a restore (None: none was).
        self.library_restored: str | None = None

    def acquire_params(self, full_load):
        """Restore the param tree (and the kernel library) from the
        snapshot when a complete one exists under this boot's
        fingerprint; otherwise run `full_load`. A `SnapshotMismatch` is a
        hard fallback — the mismatched tree is never restored — and every
        fallback records why (`absent`, `mismatch` or `error`)."""
        manifest = None
        if self.enabled:
            try:
                with self.tracker.phase("fetch"):
                    manifest = self.store.fetch(
                        self.model, self.fingerprint, self.work_dir
                    )
            except SnapshotMismatch as e:
                logger.warning("%s", e)
                self.tracker.event("mismatch")
            except Exception as e:  # noqa: BLE001 — boot must survive the store
                logger.warning("snapshot fetch failed: %s", e)
                self.tracker.event("error")
            else:
                if manifest is None:
                    self.tracker.event("absent")
        if manifest is not None:
            try:
                with self.tracker.phase("restore"):
                    lib = os.path.join(
                        self.kernels_dir, _build.build_dir().name, _build.LIB_NAME
                    )
                    if os.path.exists(lib):
                        self.library_restored = str(_build.install_library(lib))
                    params = load_native_checkpoint(self.params_dir, self.device)
                self.tracker.restored = True
                self.tracker.event("restored")
                logger.info(
                    "restored snapshot %s/%s (kernel library: %s)", self.model,
                    self.fingerprint, self.library_restored or "none in the snapshot",
                )
                return params
            except Exception as e:  # noqa: BLE001 — fall back, don't crash-loop
                logger.warning(
                    "snapshot restore failed (%s): falling back to full load",
                    e,
                )
                self.tracker.event("error")
        with self.tracker.phase("load"):
            return full_load()

    def maybe_publish(self, params) -> bool:
        """Write-back on a full-load boot, called AFTER warm-up so the
        kernel library exists. No-op when restore succeeded (the key is
        already complete), snapshots are off or the boot is
        restore-only."""
        if not self.enabled or not self.publish or self.tracker.restored:
            return False
        stage = os.path.join(self.work_dir, "publish")
        try:
            shutil.rmtree(stage, ignore_errors=True)
            os.makedirs(stage, exist_ok=True)
            save_native_checkpoint(os.path.join(stage, "params"), params)
            lib = _build.installed_library()
            if lib is not None:
                dest = os.path.join(stage, "kernels", lib.parent.name)
                os.makedirs(dest)
                shutil.copyfile(lib, os.path.join(dest, lib.name))
            self.store.publish(
                self.model,
                self.fingerprint,
                stage,
                meta={"boot_phases": dict(self.tracker.phases)},
            )
            self.tracker.event("published")
            logger.info(
                "published snapshot %s/%s", self.model, self.fingerprint
            )
            return True
        except Exception as e:  # noqa: BLE001 — publish is best-effort
            logger.warning("snapshot publish failed: %s", e)
            self.tracker.event("error")
            return False
        finally:
            shutil.rmtree(stage, ignore_errors=True)
