"""``compile(fn_or_dfg, geometry) -> CompiledArtifact`` — the compile half
of the port's execution pipeline (counterpart of ``repro.engine.compiler``).

Accepts either of the two kernel sources the code base produces:

  * a hand-built ``core.dfg.DFG`` (kernels_lib / benchmark decompositions,
    or a reference DFG carried across by ``convert``), keyed by a
    structural content digest;
  * a plain Python/torch callable, traced through the frontend
    (``frontend.tracer``) and keyed by a digest of its aten graph — the
    same key the ``@offload`` decorator uses, so both entry points share
    one artifact cache.

Either way the kernel is partitioned against the *target geometry*
(``frontend.partition.plan`` on an arbitrary ``Fabric``), every shot is
placed & routed, and the per-shot ISA configuration word streams are packed
(Sec. V-B bus format). The resulting ``CompiledArtifact`` is stored in the
persistent cache and handed to ``engine.Engine`` for execution.

Frontend modules are imported lazily, as in the reference.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from repro_torch import obs
from repro_torch.core import dfg as D
from repro_torch.core.fabric import Fabric
from repro_torch.core.isa import config_stream
from repro_torch.core.mapper import default_mapper, default_seed, generate_configs
from repro_torch.engine.artifact import (SCHEMA_VERSION, ArtifactError,
                                         CompiledArtifact, Geometry)
from repro_torch.engine.cache import ArtifactCache, default_cache


def geometry_of(fabric: Fabric) -> Geometry:
    return (fabric.rows, fabric.cols, fabric.n_imns, fabric.n_omns)


def dfg_digest(g: D.DFG, geometry: Geometry, backend: str,
               pe_limit: Optional[int] = None, mapper: str = "greedy",
               seed: int = 0) -> str:
    """Content digest of a DFG compile request. Node names participate (a
    Mapping's placement is keyed by node name, so structural equality alone
    would alias artifacts whose mappings don't transfer). ``pe_limit``
    changes the partition plan, so it keys too; ``restarts`` is a search
    budget, not a semantic input, and deliberately does not. The *mapper
    identity and seed* DO key: greedy and annealed compilations of the same
    DFG produce different mappings, and the on-disk cache must never serve
    one where the other was requested."""
    h = hashlib.sha1()
    h.update(f"v{SCHEMA_VERSION}|{g.name}|{geometry}|{backend}|"
             f"{pe_limit}|{mapper}|{seed}".encode())
    for name in sorted(g.nodes):
        n = g.nodes[name]
        op = int(n.op) if n.op is not None else -1
        h.update(f"N|{name}|{n.kind}|{op}|{n.value}|{n.acc_init}|"
                 f"{n.emit_every}".encode())
    for e in sorted(g.edges, key=lambda e: (e.src, e.src_port, e.dst,
                                            e.dst_port)):
        h.update(f"E|{e.src}|{e.src_port}|{e.dst}|{e.dst_port}|"
                 f"{int(e.back)}|{e.init}".encode())
    h.update(f"I|{g.inputs}|O|{g.outputs}".encode())
    return h.hexdigest()


def fn_cache_key(fn: Callable, length: int, mode: str, backend: str,
                 geometry: Geometry, arg_names: List[str],
                 pe_limit: Optional[int] = None, mapper: str = "greedy",
                 seed: int = 0) -> Tuple[str, Any, bool]:
    """(digest, traced graph, element_mode) for a traced-function compile.

    Traces ``fn`` once with the tracer's own mode resolution; the returned
    ``frontend.tracer.TracedGraph`` carries the output structure and shapes
    and is what a cache miss lowers, so a compile traces only once. The
    digest covers the graph *and every subgraph* (``print_readable`` prints
    the bodies of ``cond``/``while_loop``/``scan``, which ``gm.code`` names
    only), the values of captured tensor constants, and the compile
    request's length, geometry, backend, ``pe_limit``, mapper and seed.
    """
    from repro_torch.frontend import tracer
    tg = tracer.make_graph(fn, length, len(arg_names), mode)
    # a GraphModule holds the tensors its graphs read as buffers
    consts = [(name, str(t.dtype), t.tolist())
              for name, t in tg.gm.named_buffers()]
    text = tg.gm.print_readable(print_output=False)
    digest = hashlib.sha1(
        f"v{SCHEMA_VERSION}|{text}|{consts}|{length}|{geometry}|"
        f"{backend}|{pe_limit}|{mapper}|{seed}".encode()).hexdigest()
    return digest, tg, tg.element_mode


def build_artifact(g: D.DFG, key: str, fabric: Fabric, backend: str,
                   name: Optional[str] = None, length: Optional[int] = None,
                   element_mode: bool = False,
                   out_shapes: Optional[List[Tuple[int, ...]]] = None,
                   restarts: int = 200,
                   pe_limit: Optional[int] = None,
                   mapper: Optional[str] = None,
                   seed: Optional[int] = None) -> CompiledArtifact:
    """Partition + place & route + config-word emission (no cache I/O).

    The plan's required capability features are computed here and checked
    against the target backend's declared capability set — a kernel that
    exceeds it fails *at compile time* with a diagnostic naming every
    offending feature (engine/capabilities.py), not at first dispatch.
    """
    from repro_torch.engine import capabilities
    from repro_torch.frontend import partition
    name = name or g.name
    mapper = default_mapper() if mapper is None else mapper
    seed = default_seed() if seed is None else seed
    with obs.span("pnr", kernel=name, backend=backend, mapper=mapper) as sp:
        pl = partition.plan(g, fabric, restarts=restarts, pe_limit=pe_limit,
                            mapper=mapper, seed=seed)
        sp.set(shots=pl.n_shots)
    features = capabilities.plan_features(pl)
    capabilities.check_backend(features, backend, name)
    if backend == "cuda" and length is not None:
        for shot in pl.shots:
            capabilities.check_stream_length(shot.dfg, length, backend)
    config_class = f"{name}:{key[:10]}"
    words: Dict[str, List[int]] = {}
    with obs.span("config_emit", kernel=name):
        for i, shot in enumerate(pl.shots):
            # globally unique shot keys: runner memoization must never alias
            # two artifacts whose shot DFGs happen to share a name
            shot.key = config_class if pl.n_shots == 1 \
                else f"{config_class}/s{i}"
            words[shot.key] = config_stream(generate_configs(shot.mapping))
    return CompiledArtifact(
        name=name, key=key, backend=backend, geometry=geometry_of(fabric),
        plan=pl, config_words=words, config_class=config_class,
        length=length, element_mode=element_mode, out_shapes=out_shapes,
        features=tuple(sorted(features)), mapper=mapper)


def compile(fn_or_dfg: Union[Callable, D.DFG], length: Optional[int] = None,
            *, fabric: Optional[Fabric] = None, backend: str = "sim",
            mode: str = "auto", name: Optional[str] = None,
            cache: Optional[ArtifactCache] = None, restarts: int = 200,
            pe_limit: Optional[int] = None, mapper: Optional[str] = None,
            seed: Optional[int] = None) -> CompiledArtifact:
    """Compile a kernel into a cached, runnable ``CompiledArtifact``.

    ``length`` is required for callables (the traced stream extent) and
    ignored for DFGs, whose mappings are length-independent. ``mapper``
    selects place & route ("greedy" | "anneal", default from
    ``STRELA_MAPPER``) and ``seed`` the P&R RNG stream (default from
    ``STRELA_MAP_SEED``); both key the artifact digest.
    """
    fabric = fabric or Fabric()
    cache = cache if cache is not None else default_cache()
    geometry = geometry_of(fabric)
    mapper = default_mapper() if mapper is None else mapper
    seed = default_seed() if seed is None else seed

    if isinstance(fn_or_dfg, D.DFG):
        g = fn_or_dfg
        with obs.span("compile", kernel=name or g.name,
                      backend=backend) as sp:
            key = dfg_digest(g, geometry, backend, pe_limit,
                             mapper=mapper, seed=seed)
            with obs.span("cache.lookup", key=key[:12]):
                hit = cache.get(key)
            if hit is not None:
                obs.inc("compile.cache_hits")
                sp.set(cache="hit")
                return hit
            obs.inc("compile.cache_misses")
            art = build_artifact(g, key, fabric, backend, name=name,
                                 restarts=restarts, pe_limit=pe_limit,
                                 mapper=mapper, seed=seed)
            cache.put(art)
            return art

    if not callable(fn_or_dfg):
        raise ArtifactError(f"compile() takes a DFG or a callable, got "
                            f"{type(fn_or_dfg)!r}")
    if length is None:
        raise ArtifactError("compile(fn) requires the stream length")
    from repro_torch.frontend import tracer
    fn = fn_or_dfg
    kname = name or getattr(fn, "__name__", "kernel")
    with obs.span("compile", kernel=kname, backend=backend) as sp:
        arg_names = tracer.arg_names_of(fn, kname)
        key, tg, element_mode = fn_cache_key(
            fn, length, mode, backend, geometry, arg_names, pe_limit,
            mapper=mapper, seed=seed)
        with obs.span("cache.lookup", key=key[:12]):
            hit = cache.get(key)
        if hit is not None:
            obs.inc("compile.cache_hits")
            sp.set(cache="hit")
            return hit
        obs.inc("compile.cache_misses")
        with obs.span("frontend.trace", kernel=kname):
            g = tracer.lower(tg, length, kname, arg_names)
        art = build_artifact(g, key, fabric, backend, name=kname,
                             length=length, element_mode=element_mode,
                             out_shapes=tg.out_shapes(length),
                             restarts=restarts, pe_limit=pe_limit,
                             mapper=mapper, seed=seed)
        cache.put(art)
        return art
