"""Standalone deployable components: the metrics aggregation service, the
GPU-free mock worker that exercises it, and the api-store.

The counterpart of ``dynamo_tpu/components/``.  The http frontend and the
router live behind the CLI (``http``, ``router``, ``run in=dyn://``).
"""
