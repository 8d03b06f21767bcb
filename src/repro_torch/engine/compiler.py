"""``compile(dfg, geometry) -> CompiledArtifact`` — the compile half of
the port's execution pipeline (counterpart of ``repro.engine.compiler``).

Takes a hand-built ``core.dfg.DFG`` (kernels_lib / benchmark
decompositions, or a reference DFG carried across by ``convert``), keyed
by a structural content digest. The kernel is partitioned against the
*target geometry* (``frontend.partition.plan`` on an arbitrary ``Fabric``),
every shot is placed & routed, and the per-shot ISA configuration word
streams are packed (Sec. V-B bus format). The resulting
``CompiledArtifact`` is stored in the persistent cache and handed to
``engine.Engine`` for execution.

Python callables need a frontend that lowers torch code to a DFG; that
frontend is not ported yet, so ``compile`` refuses them by name.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional, Union

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


def build_artifact(g: D.DFG, key: str, fabric: Fabric, backend: str,
                   name: Optional[str] = None,
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
        features=tuple(sorted(features)), mapper=mapper)


def compile(fn_or_dfg: Union[Callable, D.DFG], length: Optional[int] = None,
            *, fabric: Optional[Fabric] = None, backend: str = "sim",
            name: Optional[str] = None,
            cache: Optional[ArtifactCache] = None, restarts: int = 200,
            pe_limit: Optional[int] = None, mapper: Optional[str] = None,
            seed: Optional[int] = None) -> CompiledArtifact:
    """Compile a kernel into a cached, runnable ``CompiledArtifact``.

    ``length`` is ignored for DFGs, whose mappings are length-independent
    (kept for signature parity with the reference). ``mapper``
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

    if callable(fn_or_dfg):
        raise ArtifactError(
            f"compile() of a Python callable "
            f"({getattr(fn_or_dfg, '__name__', fn_or_dfg)!r}) needs a torch "
            f"frontend, which repro_torch does not have yet; pass a DFG")
    raise ArtifactError(f"compile() takes a DFG, got {type(fn_or_dfg)!r}")
