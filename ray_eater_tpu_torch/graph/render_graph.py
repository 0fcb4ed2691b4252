"""Render graph — a declarative pass DAG baked into one frame program
(counterpart of ``ray_eater_tpu/graph/render_graph.py``; the reference's
design stub src/graph/render_graph.zig:6-36).

A **resource** is a named slot holding any tensor or structure of tensors
(framebuffers, textures, particle buffers); a **pass** is a function
``fn(inputs: dict) -> outputs: dict`` declaring the slots it reads and
writes. ``bake()`` validates the graph (acyclic, no undefined reads, every
output produced: the static analog of the Vulkan validation layer) and
returns a :class:`FrameProgram` that runs the passes in schedule order.

Hazard ordering: read-after-write follows the declared edges;
write-after-write and write-after-read on one slot keep the order in which
the passes were added (the "submission order" analog).

The frame program runs its passes eagerly. The JAX package's ``jit``
compiles the frame into one XLA program; here the counterpart is a CUDA
graph, which :func:`ray_eater_tpu_torch.core.animation.render_animation`
captures around a frame step, so ``bake(jit=...)`` changes nothing.
:meth:`FrameProgram.save_baked` writes the frame traced by
``torch.export`` (the kernels as their ``rayeater::*`` custom ops) and
:func:`load_baked` reads it back, the counterpart of the JAX package's
serialised StableHLO.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from typing import Callable, Sequence

import torch

from ..utils.logging import scoped

_log = scoped("graph")


class GraphValidationError(RuntimeError):
    """Raised for malformed graphs: at bake time, or when a frame program
    is called without its external slots or a pass returns the wrong
    slots."""


@dataclasses.dataclass(frozen=True)
class Pass:
    name: str
    fn: Callable[[dict], dict]
    reads: tuple[str, ...]
    writes: tuple[str, ...]


class RenderGraph:
    """Declare resources and passes, then :meth:`bake` the frame."""

    def __init__(self, name: str = "frame"):
        self.name = name
        self._passes: list[Pass] = []
        self._external: set[str] = set()
        self._outputs: list[str] = []

    def external(self, *names: str) -> "RenderGraph":
        """Declare slots the caller provides each frame."""
        self._external.update(names)
        return self

    def add_pass(self, name: str, fn: Callable, reads: Sequence[str] = (),
                 writes: Sequence[str] = ()) -> "RenderGraph":
        if any(p.name == name for p in self._passes):
            raise GraphValidationError(f"duplicate pass name: {name!r}")
        if not writes:
            raise GraphValidationError(f"pass {name!r} writes nothing")
        self._passes.append(Pass(name, fn, tuple(reads), tuple(writes)))
        return self

    def output(self, *names: str) -> "RenderGraph":
        """Declare the slots the frame program returns."""
        self._outputs.extend(names)
        return self

    def _schedule(self) -> list[Pass]:
        """Validate and toposort (Kahn's order, ties by insertion)."""
        passes = self._passes
        if not passes:
            raise GraphValidationError("graph has no passes")
        written = {w for p in passes for w in p.writes}
        for p in passes:
            for r in p.reads:
                if r not in written and r not in self._external:
                    raise GraphValidationError(
                        f"pass {p.name!r} reads undefined resource {r!r} "
                        f"(declare it external() or write it in a pass)")
        for o in self._outputs:
            if o not in written and o not in self._external:
                raise GraphValidationError(f"output {o!r} never produced")

        # Edges with resource versions: a reader binds to the latest
        # earlier writer (or the external initial value); a read declared
        # before any write of a non-external resource with one writer binds
        # forward to it, so producer/consumer chains may be declared in any
        # order; with several writers that binding would be ambiguous.
        n = len(passes)
        writers: dict[str, list[int]] = {}
        for i, p in enumerate(passes):
            for w in p.writes:
                writers.setdefault(w, []).append(i)
        edges: set[tuple[int, int]] = set()
        last_writer: dict[str, int] = {}
        readers_since_write: dict[str, list[int]] = {}
        for i, p in enumerate(passes):
            for r in p.reads:
                if r in last_writer:
                    edges.add((last_writer[r], i))
                elif r in self._external:
                    pass
                elif len(writers.get(r, ())) == 1:
                    edges.add((writers[r][0], i))   # forward binding
                    continue
                else:
                    raise GraphValidationError(
                        f"pass {p.name!r} reads {r!r} before any of its "
                        f"{len(writers[r])} writers — declaration order is "
                        f"ambiguous; declare a writer first")
                readers_since_write.setdefault(r, []).append(i)
            for w in p.writes:
                if w in last_writer:
                    edges.add((last_writer[w], i))          # WAW
                for j in readers_since_write.get(w, ()):
                    if j != i:
                        edges.add((j, i))                   # WAR
                last_writer[w] = i
                readers_since_write[w] = []

        indeg = [0] * n
        adj: dict[int, list[int]] = {i: [] for i in range(n)}
        for a, b in edges:
            adj[a].append(b)
            indeg[b] += 1
        order, ready = [], [i for i in range(n) if indeg[i] == 0]
        while ready:
            i = min(ready)
            ready.remove(i)
            order.append(i)
            for j in adj[i]:
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.append(j)
        if len(order) != n:
            cyc = [passes[i].name for i in range(n) if i not in order]
            raise GraphValidationError(f"pass DAG has a cycle among {cyc}")
        return [passes[i] for i in order]

    def bake(self, jit: bool = True,
             donate: Sequence[str] = ()) -> "FrameProgram":
        """Validate, schedule and return the frame program.

        ``jit`` is accepted for the reference's signature and changes
        nothing (the frame runs eagerly; capture is
        ``render_animation``'s job). ``donate`` names external slots the
        caller hands over (the framebuffer-ring pattern); they must be
        external, and are recorded on the program. Passes return new
        tensors, so no buffer is reused in place."""
        schedule = self._schedule()
        outputs = list(self._outputs) or sorted(
            {w for p in schedule for w in p.writes})
        externals = sorted(self._external)
        unknown = set(donate) - set(externals)
        if unknown:
            raise GraphValidationError(f"donate of non-external {unknown}")
        _log.info("graph %s baked: %s -> %s", self.name,
                  [p.name for p in schedule], outputs)
        return FrameProgram(self.name, externals, outputs, schedule,
                            sorted(set(donate)))


@dataclasses.dataclass
class FrameProgram:
    """A baked frame: call with the external slots, get the output slots."""
    name: str
    externals: list[str]
    outputs: list[str]
    schedule: list[Pass]
    donated: list[str] = dataclasses.field(default_factory=list)

    def __call__(self, **env) -> dict:
        missing = [e for e in self.externals if e not in env]
        if missing:
            raise GraphValidationError(
                f"frame {self.name!r} missing external slots {missing}")
        for p in self.schedule:
            outs = p.fn({r: env[r] for r in p.reads})
            if not isinstance(outs, dict) or set(outs) != set(p.writes):
                raise GraphValidationError(
                    f"pass {p.name!r} must return dict with keys "
                    f"{sorted(p.writes)}, got "
                    f"{sorted(outs) if isinstance(outs, dict) else type(outs)}")
            env.update(outs)
        return {o: env[o] for o in self.outputs}

    @property
    def pass_names(self) -> list[str]:
        return [p.name for p in self.schedule]

    def save_baked(self, path: str, **example_env) -> None:
        """Serialise the frame program: traced by ``torch.export`` on the
        example external slots (tensors of the shapes, dtypes and device
        the frame will be called with) and written by
        ``torch.export.save``, the counterpart of the JAX package's
        StableHLO artifact. The kernels trace as their custom ops
        (``rayeater::*``); tensors the passes close over (a splat cloud, a
        texture) are stored in the file. :func:`load_baked` reads it back
        without the passes' Python."""
        missing = [e for e in self.externals if e not in example_env]
        if missing:
            raise GraphValidationError(f"save_baked missing {missing}")
        env = {k: example_env[k] for k in self.externals}
        bad = [k for k, v in env.items() if not isinstance(v, torch.Tensor)]
        if bad:
            raise GraphValidationError(
                f"save_baked: external slots {bad} must be tensors")
        specs: list = []
        exported = torch.export.export(_frame_module(self, specs), (env,),
                                       strict=False)
        spec = {"name": self.name, "externals": self.externals,
                "out": specs[-1]}
        torch.export.save(exported, path,
                          extra_files={_SPEC_FILE: json.dumps(spec)})
        _log.info("baked frame %s -> %s", self.name, path)


#: the archive entry that holds a baked frame's slots and output structure
_SPEC_FILE = "rayeater_frame.json"


def _flatten(x, leaves: list):
    """The structure of a frame output with its tensors appended to
    ``leaves``: tensors, dicts, lists, tuples, dataclasses (a
    ``Framebuffer``) and plain values (kept in the structure)."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ["tensor"]
    if isinstance(x, dict):
        return ["dict", [[k, _flatten(v, leaves)] for k, v in x.items()]]
    if isinstance(x, (list, tuple)):
        return ["list" if isinstance(x, list) else "tuple",
                [_flatten(v, leaves) for v in x]]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = type(x)
        return ["dataclass", f"{cls.__module__}:{cls.__qualname__}",
                [[f.name, _flatten(getattr(x, f.name), leaves)]
                 for f in dataclasses.fields(x)]]
    if x is None or isinstance(x, (bool, int, float, str)):
        return ["value", x]
    raise GraphValidationError(f"cannot bake a frame output of type "
                               f"{type(x).__name__}")


def _unflatten(spec, leaves):
    kind = spec[0]
    if kind == "tensor":
        return next(leaves)
    if kind == "dict":
        return {k: _unflatten(v, leaves) for k, v in spec[1]}
    if kind in ("list", "tuple"):
        items = [_unflatten(v, leaves) for v in spec[1]]
        return items if kind == "list" else tuple(items)
    if kind == "dataclass":
        module, qualname = spec[1].split(":")
        cls = importlib.import_module(module)
        for part in qualname.split("."):
            cls = getattr(cls, part)
        return cls(**{k: _unflatten(v, leaves) for k, v in spec[2]})
    return spec[1]


def _frame_module(prog: FrameProgram, specs: list) -> torch.nn.Module:
    """``prog`` as a module for ``torch.export``: ``forward`` takes the
    external slots as one dict and returns the output slots' tensors
    flattened, and appends their structure (:func:`_flatten`) to
    ``specs``. ``specs`` is held by the closure, not by the module, since
    export restores a module's attributes after tracing."""
    class Frame(torch.nn.Module):
        def forward(self, env: dict):
            leaves: list = []
            specs.append(_flatten(prog(**env), leaves))
            return tuple(leaves)
    return Frame()


def load_baked(path: str):
    """Load a frame program written by :meth:`FrameProgram.save_baked`.
    Returns a callable ``loaded(**env) -> dict`` taking the external slots
    as the frame program does, on the device it was traced on, and
    raising :class:`GraphValidationError` for missing slots."""
    from ..ops import gs, raster, sampling, splat  # noqa: F401 (the ops)
    extra = {_SPEC_FILE: ""}
    exported = torch.export.load(path, extra_files=extra)
    spec = json.loads(extra[_SPEC_FILE])
    run = exported.module()

    def loaded(**env) -> dict:
        missing = [e for e in spec["externals"] if e not in env]
        if missing:
            raise GraphValidationError(
                f"baked frame {spec['name']!r} missing external slots "
                f"{missing}")
        out = run({k: env[k] for k in spec["externals"]})
        return _unflatten(spec["out"], iter(out))

    return loaded
