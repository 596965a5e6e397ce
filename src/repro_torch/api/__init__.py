"""repro_torch.api — the port's front door for alignment serving.

    from repro_torch.api import plan
    session = plan(W=64, O=24, k=12, backend="fused", rescue_rounds=2,
                   executor="thread")              # device="cuda"
    session.warmup([(10_000, 13_000)])       # prepare before traffic
    fut = session.submit(read_codes, ref_codes)
    ...
    print(fut.result()["cigar"], session.session_stats())
    session.close()                          # or use it as a context manager

``plan(..., device="cpu")`` runs the kernels' plain PyTorch versions; the
default is the card, and it raises where there is none.
"""
from .session import (AlignExecutable, AlignFuture, AlignSession, AlignSpec,
                      CompileCache, RequestCancelled, SessionPoisonedError,
                      plan, shared_compile_cache)

__all__ = ["AlignExecutable", "AlignFuture", "AlignSession", "AlignSpec",
           "CompileCache", "RequestCancelled", "SessionPoisonedError", "plan",
           "shared_compile_cache"]
