"""Versioned artifact registry (the port's copy of the JAX package's
``serve/registry.py``): ``registry.json`` names the models a replica
serves, each with its artifact, version, bucket ladder, pre-warm budget and
SLO; ``serve --registry`` loads every entry as its own engine and batcher.

Reads are strict: ``schema_version`` is checked and unknown fields, top
level or per entry, are rejected. A workdir without ``registry.json`` loads
as an implicit one-entry registry under :data:`DEFAULT_MODEL`. Writes go
through a temporary file and ``os.replace``, and a version only moves
forward.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

REGISTRY_FILENAME = "registry.json"
SCHEMA_VERSION = 1

# the implicit tenant name legacy single-artifact fleets (and requests that
# don't name a model) resolve to
DEFAULT_MODEL = "default"

# ledger event emitted when a registry entry's version flips (promotion)
REGISTRY_FLIP_EVENT = "registry_flip"


class RegistryError(ValueError):
    """The registry document is corrupt, unknown-versioned, or carries
    fields this build does not understand."""


def _expect(cond: bool, msg: str) -> None:
    if not cond:
        raise RegistryError(f"registry.json: {msg}")


@dataclasses.dataclass
class ModelEntry:
    """One tenant: a named model with its own artifact, ladder, and SLO.

    ``weight``, the replica counts, ``chips_per_replica`` and
    ``device_slots`` (visible-device masks handed round-robin to the model's
    replicas) are the fleet tier's (queue A 14); a replica reads and keeps
    them so that one document serves both.
    """

    name: str
    artifact_dir: str
    version: int = 1
    buckets: Optional[Tuple[int, ...]] = None  # None -> fleet default ladder
    prewarm_budget: Optional[int] = None  # None -> warm the whole ladder
    weight: float = 1.0
    slo_p99_ms: Optional[float] = None
    slo_error_budget: Optional[float] = None
    replicas: int = 1  # initial replica count at fleet start
    min_replicas: int = 1
    max_replicas: Optional[int] = None
    chips_per_replica: int = 1
    device_slots: Optional[Tuple[str, ...]] = None

    # every key the on-disk entry may carry; anything else is a hard error
    _FIELDS = (
        "name",
        "artifact_dir",
        "version",
        "buckets",
        "prewarm_budget",
        "weight",
        "slo_p99_ms",
        "slo_error_budget",
        "replicas",
        "min_replicas",
        "max_replicas",
        "chips_per_replica",
        "device_slots",
    )

    def __post_init__(self):
        _expect(
            isinstance(self.name, str) and self.name,
            f"model name must be a non-empty string, got {self.name!r}",
        )
        _expect(
            "/" not in self.name and not self.name.startswith("."),
            f"model name {self.name!r} must not look like a path",
        )
        _expect(
            isinstance(self.artifact_dir, str) and self.artifact_dir,
            f"model {self.name!r}: artifact_dir must be a non-empty string",
        )
        _expect(
            isinstance(self.version, int)
            and not isinstance(self.version, bool)
            and self.version >= 1,
            f"model {self.name!r}: version must be an int >= 1, "
            f"got {self.version!r}",
        )
        if self.buckets is not None:
            _expect(
                all(isinstance(b, int) and b >= 1 for b in self.buckets)
                and len(self.buckets) > 0,
                f"model {self.name!r}: buckets must be positive ints",
            )
            self.buckets = tuple(sorted({int(b) for b in self.buckets}))
        if self.prewarm_budget is not None:
            _expect(
                isinstance(self.prewarm_budget, int)
                and not isinstance(self.prewarm_budget, bool)
                and self.prewarm_budget >= 0,
                f"model {self.name!r}: prewarm_budget must be an int >= 0",
            )
        _expect(
            isinstance(self.weight, (int, float))
            and not isinstance(self.weight, bool)
            and self.weight > 0,
            f"model {self.name!r}: weight must be > 0",
        )
        for knob in ("slo_p99_ms", "slo_error_budget"):
            v = getattr(self, knob)
            if v is not None:
                _expect(
                    isinstance(v, (int, float))
                    and not isinstance(v, bool)
                    and v > 0,
                    f"model {self.name!r}: {knob} must be > 0",
                )
        _expect(
            isinstance(self.replicas, int) and self.replicas >= 1,
            f"model {self.name!r}: replicas must be an int >= 1",
        )
        _expect(
            isinstance(self.min_replicas, int) and self.min_replicas >= 1,
            f"model {self.name!r}: min_replicas must be an int >= 1",
        )
        if self.max_replicas is not None:
            _expect(
                isinstance(self.max_replicas, int)
                and self.max_replicas >= self.min_replicas,
                f"model {self.name!r}: max_replicas must be >= min_replicas",
            )
        _expect(
            isinstance(self.chips_per_replica, int)
            and self.chips_per_replica >= 1,
            f"model {self.name!r}: chips_per_replica must be an int >= 1",
        )
        if self.device_slots is not None:
            _expect(
                len(self.device_slots) > 0
                and all(
                    isinstance(s, str) and s for s in self.device_slots
                ),
                f"model {self.name!r}: device_slots must be non-empty "
                "strings (visible-device masks like '0,1')",
            )
            self.device_slots = tuple(self.device_slots)

    @classmethod
    def from_json(cls, obj: Dict) -> "ModelEntry":
        _expect(
            isinstance(obj, dict),
            f"model entry must be an object, got {type(obj).__name__}",
        )
        unknown = sorted(set(obj) - set(cls._FIELDS))
        _expect(
            not unknown,
            f"model entry {obj.get('name')!r} carries unknown field(s) "
            f"{unknown} — this build does not understand them",
        )
        _expect("name" in obj, "model entry missing required field 'name'")
        _expect(
            "artifact_dir" in obj,
            f"model {obj['name']!r} missing required field 'artifact_dir'",
        )
        kwargs = dict(obj)
        for seq_field in ("buckets", "device_slots"):
            if kwargs.get(seq_field) is not None:
                _expect(
                    isinstance(kwargs[seq_field], list),
                    f"model {obj['name']!r}: {seq_field} must be a list",
                )
                kwargs[seq_field] = tuple(kwargs[seq_field])
        return cls(**kwargs)

    def to_json(self) -> Dict:
        out: Dict = {
            "name": self.name,
            "artifact_dir": self.artifact_dir,
            "version": self.version,
        }
        for field in self._FIELDS[3:]:
            v = getattr(self, field)
            default = next(
                f.default for f in dataclasses.fields(self) if f.name == field
            )
            if v != default:
                out[field] = list(v) if isinstance(v, tuple) else v
        return out

    def device_slot(self, ordinal: int) -> Optional[str]:
        """Visible-device mask for this model's ``ordinal``-th replica
        (round-robin over the declared slots)."""
        if not self.device_slots:
            return None
        return self.device_slots[ordinal % len(self.device_slots)]


class Registry:
    """The loaded document: ordered model entries plus the path to flip."""

    def __init__(
        self,
        models: List[ModelEntry],
        *,
        path: Optional[str] = None,
        implicit: bool = False,
    ):
        _expect(len(models) > 0, "registry must hold at least one model")
        names = [m.name for m in models]
        _expect(
            len(set(names)) == len(names),
            f"duplicate model names: {sorted(names)}",
        )
        self.models: Dict[str, ModelEntry] = {m.name: m for m in models}
        self.path = path
        # True when synthesized from a legacy single-artifact workdir —
        # there is no document on disk to rewrite
        self.implicit = implicit
        self._lock = threading.Lock()

    def __contains__(self, name: str) -> bool:
        return name in self.models

    def __len__(self) -> int:
        return len(self.models)

    def entry(self, name: str) -> ModelEntry:
        try:
            return self.models[name]
        except KeyError:
            raise RegistryError(
                f"unknown model {name!r}; registry holds "
                f"{sorted(self.models)}"
            ) from None

    def names(self) -> List[str]:
        return list(self.models)

    def total_weight(self) -> float:
        return sum(m.weight for m in self.models.values())

    def to_json(self) -> Dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "models": [m.to_json() for m in self.models.values()],
        }

    def save(self, path: Optional[str] = None) -> str:
        """Atomically persist the document (tmp + rename)."""
        path = path or self.path
        if path is None:
            raise RegistryError("registry has no path to save to")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        self.path = path
        return path

    def set_version(
        self,
        name: str,
        artifact_dir: str,
        *,
        version: Optional[int] = None,
        telemetry=None,
    ) -> ModelEntry:
        """The promotion flip: point ``name`` at a new artifact dir and bump
        its version, rewriting the on-disk document atomically. Other
        entries are untouched — tenants keep serving through the flip."""
        with self._lock:
            entry = self.entry(name)
            old_version = entry.version
            entry.artifact_dir = artifact_dir
            entry.version = (
                version if version is not None else old_version + 1
            )
            _expect(
                entry.version > old_version,
                f"model {name!r}: version must move forward "
                f"({old_version} -> {entry.version})",
            )
            if not self.implicit and self.path:
                self.save()
        if telemetry is not None:
            telemetry.event(
                REGISTRY_FLIP_EVENT,
                model=name,
                artifact_dir=artifact_dir,
                version=entry.version,
                previous_version=old_version,
            )
        return entry


def registry_path(workdir: str) -> str:
    return os.path.join(workdir, REGISTRY_FILENAME)


def write_registry(workdir: str, models: List[ModelEntry]) -> Registry:
    reg = Registry(models, path=registry_path(workdir))
    reg.save()
    return reg


def _load_document(path: str) -> List[ModelEntry]:
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except json.JSONDecodeError as e:
        raise RegistryError(f"registry.json is not valid JSON: {e}") from e
    _expect(isinstance(doc, dict), "top level must be an object")
    unknown = sorted(set(doc) - {"schema_version", "models"})
    _expect(not unknown, f"unknown top-level field(s) {unknown}")
    _expect(
        doc.get("schema_version") == SCHEMA_VERSION,
        f"schema_version {doc.get('schema_version')!r} is not the "
        f"supported version {SCHEMA_VERSION}",
    )
    _expect(
        isinstance(doc.get("models"), list) and doc["models"],
        "'models' must be a non-empty list",
    )
    return [ModelEntry.from_json(m) for m in doc["models"]]


def read_registry(
    workdir: str,
    *,
    default_artifact_dir: Optional[str] = None,
    path: Optional[str] = None,
) -> Registry:
    """Load the workdir's registry, or synthesize the legacy implicit one.

    Resolution order:

    1. explicit ``path`` (``serve --registry``),
    2. ``<workdir>/registry.json``,
    3. legacy fallback — ``default_artifact_dir`` (the old
       ``--artifact-dir`` flag) becomes a one-entry implicit registry under
       :data:`DEFAULT_MODEL`.
    """
    if path is not None:
        return Registry(_load_document(path), path=path)
    candidate = registry_path(workdir) if workdir else None
    if candidate and os.path.exists(candidate):
        return Registry(_load_document(candidate), path=candidate)
    if default_artifact_dir is not None:
        return Registry(
            [ModelEntry(name=DEFAULT_MODEL, artifact_dir=default_artifact_dir)],
            implicit=True,
        )
    raise RegistryError(
        f"no {REGISTRY_FILENAME} in {workdir!r} and no legacy "
        "--artifact-dir to fall back to"
    )
