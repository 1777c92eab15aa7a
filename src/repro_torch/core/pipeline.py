"""v2 declarative pipeline surface: ModuleRegistry + PipelineSpec.

The paper's "flexibility through modular design" means the set of resilience
modules is *open*: compression, integrity, erasure and format-conversion
strategies slot into the pipeline by priority without editing the engine or
the client.  The seed hardwired the pipeline in ``VelocClient.__init__``;
here the pipeline is data:

    @register_module("mirror")
    class MirrorModule(Module):
        priority = 35
        def process(self, ctx): ...

    spec = PipelineSpec(name="run", mode="async", modules=[
        ModuleSpec("serialize", {"encoding": "zlib"}),
        ModuleSpec("local"),
        ModuleSpec("mirror"),
        ModuleSpec("flush"),
    ])
    engine = spec.compile(backend=backend)

``VelocConfig`` (the legacy closed-set config) compiles down to a
``PipelineSpec`` via ``VelocConfig.to_pipeline_spec()`` — same modules, same
priorities, byte-identical on-disk output.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional


class ModuleRegistry:
    """Open name -> module-factory registry.

    A factory is any callable returning a ``Module`` when called with the
    spec's option dict as keyword arguments — usually the module class
    itself.
    """

    def __init__(self):
        self._factories: dict[str, Callable] = {}

    def register(self, name: str, factory: Optional[Callable] = None, *,
                 override: bool = False):
        """Register ``factory`` under ``name``; usable as a decorator."""

        def do_register(f):
            if not override and name in self._factories:
                raise ValueError(
                    f"module {name!r} already registered "
                    f"(pass override=True to replace)")
            self._factories[name] = f
            return f

        if factory is not None:
            return do_register(factory)
        return do_register

    def get(self, name: str) -> Callable:
        try:
            return self._factories[name]
        except KeyError:
            raise KeyError(
                f"unknown module {name!r}; registered: {sorted(self._factories)}"
            ) from None

    def create(self, name: str, **options):
        return self.get(name)(**options)

    def names(self) -> list[str]:
        return sorted(self._factories)

    def __contains__(self, name: str) -> bool:
        return name in self._factories


#: The default registry; built-in modules register here on import of
#: ``repro_torch.core.modules``.
MODULES = ModuleRegistry()


def register_module(name: str, factory: Optional[Callable] = None, *,
                    registry: Optional[ModuleRegistry] = None,
                    override: bool = False):
    """``@register_module("xor")`` — add a module factory to the default
    registry (or ``registry`` when given)."""
    return (registry or MODULES).register(name, factory, override=override)


@dataclass
class ModuleSpec:
    """One pipeline stage: a registered module name + its options.

    ``priority`` overrides the module class's default priority so custom
    modules (and reorderings) slot in declaratively.
    """

    name: str
    options: dict = field(default_factory=dict)
    priority: Optional[int] = None


def _default_modules() -> list[ModuleSpec]:
    return [ModuleSpec("serialize"), ModuleSpec("local"), ModuleSpec("flush")]


@dataclass
class PipelineSpec:
    """Declarative checkpoint pipeline; ``compile()`` produces an ``Engine``.

    mode          "async" (active backend drains everything past
                  ``blocking_cut``) or "sync" (whole pipeline inline).
    modules       ordered only by each module's priority — list order is
                  irrelevant, matching the engine's contract.
    blocking_cut  highest priority that still runs inline in async mode
                  (VELOC semantics: block only until the fastest level holds
                  the checkpoint).
    """

    name: str = "ckpt"
    mode: str = "async"                     # async | sync
    modules: list[ModuleSpec] = field(default_factory=_default_modules)
    blocking_cut: int = 5
    backend_workers: int = 2
    phase_predictor: str = "none"           # none | ema | gru
    keep_versions: int = 3                  # GC horizon (0 = no count limit)
    #: per-stream age-based retention: versions older than this many
    #: seconds are retired by GC even when inside the ``keep_versions``
    #: window (the newest version always survives, and a retained delta
    #: still pins its full base + chain whatever their age).  None = no
    #: age limit; GC runs when either retention knob is set.
    max_age_s: Optional[float] = None
    # ---- tenant / lane knobs (multi-stream backends) -----------------
    #: deficit-round-robin share of the backend's workers relative to the
    #: other streams on the same backend (2.0 = served twice as often)
    lane_weight: float = 1.0
    #: private flush-byte budget for this stream: explicit bytes/sec ...
    lane_rate_bps: Optional[float] = None
    #: ... or a fraction carved from the cluster's global rate limit
    #: (mutually exclusive with lane_rate_bps)
    lane_rate_share: Optional[float] = None
    #: admission high-water marks: refuse (skip) new checkpoints for this
    #: stream once this many of its tasks are queued+running / this many
    #: payload bytes are queued on its lane.  None = never refuse.
    admit_max_queued: Optional[int] = None
    admit_max_queued_bytes: Optional[int] = None
    #: aggregated write path: stage every L3 blob of a version (shards,
    #: parity, manifests) into one segment put on an opted-in external tier
    aggregate: bool = False
    #: bounded seal retry: after a failed segment/pack seal put the batch is
    #: retained and up to this many maintenance-lane re-seals are scheduled,
    #: upgrading the version from L1/L2-only to full L3 protection when the
    #: tier recovers (0 = a failed seal stays failed until GC).  Forwarded
    #: into the flush module unless its ModuleSpec sets it explicitly.
    seal_retries: int = 0
    #: re-seal attempt N starts no earlier than ``base * 2**N`` seconds
    #: after scheduling (capped below) — exponential backoff so a tier that
    #: is down for minutes is probed a handful of times, not hammered every
    #: maintenance window.  0 = legacy maintenance_interval_s-only spacing.
    seal_backoff_base_s: float = 0.25
    seal_backoff_cap_s: float = 15.0
    #: delta-chain depth that triggers automatic compaction (0 = manual
    #: ``client.compact()`` only)
    compact_threshold: int = 0
    #: run auto-compaction (and the follow-up parity refresh) in the
    #: backend's maintenance lane instead of inline in checkpoint_end
    compact_async: bool = False
    #: device-side dirty tracking (fingerprint-diff protected tensors in
    #: device memory, gather only dirty chunks).  Not ported yet: ``compile``
    #: refuses it, like the "delta" module it requires.
    device_delta: bool = False
    #: min seconds between maintenance-lane task starts (rate limit)
    maintenance_interval_s: float = 0.0

    def module_options(self, name: str) -> Optional[dict]:
        """Options of the first spec entry named ``name`` (None if absent)."""
        for ms in self.modules:
            if ms.name == name:
                return ms.options
        return None

    def erasure_group_size(self) -> int:
        """The XOR/RS group width this pipeline encodes with (0 when no
        erasure module is configured).  Mirrors XorGroupModule's default so
        a bare ModuleSpec("xor") resolves consistently."""
        opts = self.module_options("xor")
        if opts is None:
            return 0
        return opts.get("group_size", 4)

    def build_modules(self) -> list:
        import repro_torch.core.modules  # noqa: F401 — registers the built-ins
        out = []
        for ms in self.modules:
            options = ms.options
            if ms.name == "flush":
                extra = {}
                if self.seal_retries and "seal_retries" not in options:
                    extra["seal_retries"] = self.seal_retries
                if "seal_backoff_base" not in options:
                    extra["seal_backoff_base"] = self.seal_backoff_base_s
                if "seal_backoff_cap" not in options:
                    extra["seal_backoff_cap"] = self.seal_backoff_cap_s
                if extra:
                    options = dict(options, **extra)
            mod = MODULES.create(ms.name, **options)
            if ms.priority is not None:
                mod.priority = ms.priority
            out.append(mod)
        return out

    def compile(self, backend=None):
        """Build the Engine.  ``backend`` is the ActiveBackend for async
        mode (None runs the full pipeline inline)."""
        from repro_torch.core.engine import Engine

        if self.device_delta or \
                any(ms.name == "delta" for ms in self.modules):
            raise NotImplementedError(
                "delta checkpointing (the \"delta\" module, device_delta) "
                "is not ported yet: ROADMAP.md queue 1, items 4-5")
        if self.aggregate and self.module_options("flush") is None:
            # the flush stage seals the batch; without it staged entries
            # (manifests, parity) would never reach stable storage.
            raise ValueError(
                'aggregate=True requires the "flush" module (the last '
                "rank's flush seals the version's segment)")
        self.validate_tenant_knobs()
        return Engine(self.build_modules(), backend,
                      blocking_cut=self.blocking_cut)

    def validate_tenant_knobs(self):
        """Reject tenant/retention knob combinations at compile time, not
        mid-checkpoint: misconfigured admission or budgets on one stream
        of a shared backend would otherwise surface as another tenant's
        mystery latency."""
        if self.keep_versions < 0:
            raise ValueError(
                f"keep_versions must be >= 0, got {self.keep_versions}")
        if self.max_age_s is not None and self.max_age_s <= 0:
            raise ValueError(
                f"max_age_s must be > 0 (or None), got {self.max_age_s}")
        if self.lane_weight <= 0:
            raise ValueError(
                f"lane_weight must be > 0, got {self.lane_weight}")
        if self.lane_rate_bps is not None and self.lane_rate_share is not None:
            raise ValueError(
                "set lane_rate_bps or lane_rate_share, not both")
        if self.lane_rate_bps is not None and self.lane_rate_bps <= 0:
            raise ValueError(
                f"lane_rate_bps must be > 0, got {self.lane_rate_bps}")
        if self.lane_rate_share is not None \
                and not 0 < self.lane_rate_share <= 1:
            raise ValueError(
                f"lane_rate_share must be in (0, 1], got "
                f"{self.lane_rate_share}")
        if self.admit_max_queued is not None and self.admit_max_queued < 1:
            raise ValueError(
                f"admit_max_queued must be >= 1, got {self.admit_max_queued}")
        if self.admit_max_queued_bytes is not None \
                and self.admit_max_queued_bytes < 1:
            raise ValueError(
                f"admit_max_queued_bytes must be >= 1, got "
                f"{self.admit_max_queued_bytes}")
