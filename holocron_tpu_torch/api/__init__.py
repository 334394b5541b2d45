"""The classification service (``api/app``) on the port: routes, micro-batcher and a
stdlib HTTP server over the deploy forward captured once per batch bucket.

    HOLOCRON_DEVICE=cpu python -m holocron_tpu_torch.api.main   # the CPU, for tests
    python -m holocron_tpu_torch.api.main                       # the card
"""
