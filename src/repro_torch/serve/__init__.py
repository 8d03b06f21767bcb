"""repro_torch.serve — always-on serving on top of the batching Engine
(counterpart of ``repro.serve``).

Turns the synchronous ``Engine.submit/flush`` library call into a
service: asynchronously arriving request streams, continuous config-class
batching (size / deadline / class-switch close), shot-boundary preemption
of long multi-shot plans, bounded-queue admission control with named
``AdmissionError`` rejections, and SLO tracking — all replayable
bit-exactly under a :class:`VirtualClock` (DESIGN.md §14).

Two front ends over one deterministic state machine:

  * :class:`ServeEngine.drive` — discrete-event loop under a virtual
    clock (tests, benchmarks, trace replay);
  * :class:`Server` — worker thread + thread-safe ingress queue under a
    wall clock (real always-on operation).

On ``Engine(backend="cuda")`` every served batch runs through the CUDA
lane kernel on the engine's device. Both mixes are served: the paper
mix and the model-layer mix of ``repro_torch.workloads`` (``mix="model"``,
or ``"all"`` for both); a class the backend cannot lower is dropped with
a named reason.
"""
from repro_torch.serve.clock import VirtualClock, WallClock
from repro_torch.serve.health import LivenessProbe
from repro_torch.serve.load import (artifact_skip_reason,
                                    bursty_arrival_times, compile_recipe,
                                    make_labeled_requests, make_requests,
                                    mix_recipes, model_classes,
                                    poisson_arrival_times,
                                    recipe_skip_reason, request_inputs,
                                    serve_classes)
from repro_torch.serve.loop import (AdmissionError, ServeConfig,
                                    ServeEngine, Server, Ticket)
from repro_torch.serve.slo import SLOTracker

__all__ = [
    "AdmissionError", "LivenessProbe", "Server", "ServeConfig",
    "ServeEngine", "SLOTracker", "Ticket", "VirtualClock", "WallClock",
    "artifact_skip_reason", "bursty_arrival_times", "compile_recipe",
    "make_labeled_requests", "make_requests", "mix_recipes",
    "model_classes", "poisson_arrival_times", "recipe_skip_reason",
    "request_inputs", "serve_classes",
]
