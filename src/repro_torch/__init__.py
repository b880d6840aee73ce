"""PyTorch/CUDA port of the multiserver-job simulator (the ``repro`` package).

``repro_torch`` runs the paper's Fig. 1/2 sweep — FCFS, ModifiedBS-π and
BS-π over the Figure-1 workload — and its Fig. 3 HPC-trace path (the
Table-2/3 workloads, bootstrapped, on those three policies and the
preemptive SF-SRPT / FF-SRPT) on float64 PyTorch tensors, with the event
scans as hand-written CUDA kernels for Hopper.  It imports ``torch``
and ``numpy`` only; the JAX package beside it is its reference.

Entry points run on the card unless the caller asks for the CPU::

    from repro_torch.core import engines, workload
    wl = workload.figure1_workload(256)
    res = engines.simulate("bs-fcfs", wl.sample_traces(10_000, 16), wl=wl)

``device="cpu"`` runs the plain PyTorch versions of the kernels instead.
The Fig. 3 entry point is ``python -m repro_torch.bench.fig3_traces``.

It also serves LLM requests with BS-π admission (``serve.engine.
ServingEngine``) on the dense, MoE, RWKV6 and hybrid decoders of
``models/`` (``chip_smoke.py`` runs stablelm-3b, yi-9b,
moonshot-v1-16b-a3b and rwkv6-7b at full width on the card, and one block
of jamba-1.5-large at full width), whose prefill and decode attention
are the hand-written ``flash_attention`` and ``decode_attention``
kernels, whose MoE expert products are the hand-written grouped matmul
``gmm``, whose RWKV6 prefill runs the hand-written chunked ``wkv`` and
whose Mamba prefill runs the hand-written selective scan
``mamba_scan``.
"""
