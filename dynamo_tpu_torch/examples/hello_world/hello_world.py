"""Hello-world serving graph: the three-stage SDK pipeline.

The port's copy of the JAX package's ``examples/hello_world/hello_world.py``.
The smallest graph — no model, no GPU — showing the component model end to
end (ref: examples/hello_world/hello_world.py):

    Frontend ──▶ Middle ──▶ Backend

Each stage is a @service; `depends()` declares the edge and gives the
upstream stage a typed client for the downstream one.  Every endpoint is
an async generator: responses stream through the whole graph.

Run in-process:

    python dynamo_tpu_torch/examples/hello_world/hello_world.py

or under the supervisor (one process per service, coordinator-discovered):

    python -m dynamo_tpu_torch serve dynamo_tpu_torch.examples.hello_world.hello_world:Frontend

Pipeline behavior: Frontend prefixes, Middle shouts, Backend splits into
words — a request "world" streams back "HELLO-WORLD!" word by word.
"""

from __future__ import annotations

import os
import sys

# runnable standalone: python dynamo_tpu_torch/examples/hello_world/hello_world.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))

from dynamo_tpu_torch.sdk import depends, dynamo_endpoint, service


@service(dynamo={"namespace": "hello"})
class Backend:
    @dynamo_endpoint
    async def generate(self, text: str):
        for word in text.split("-"):
            yield word


@service(dynamo={"namespace": "hello"})
class Middle:
    backend = depends(Backend)

    @dynamo_endpoint
    async def generate(self, text: str):
        async for word in self.backend.generate(text.upper() + "!"):
            yield word


@service(dynamo={"namespace": "hello"})
class Frontend:
    middle = depends(Middle)

    @dynamo_endpoint
    async def generate(self, text: str):
        async for word in self.middle.generate(f"hello-{text}"):
            yield word


async def main() -> None:
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.transports.coordinator import CoordinatorServer
    from dynamo_tpu_torch.sdk import serve_graph

    srv = await CoordinatorServer(port=0).start()
    try:
        handle = await serve_graph(
            Frontend, runtime_config=RuntimeConfig(coordinator_url=srv.url)
        )
        try:
            out = []
            async for word in handle.instances["Frontend"].generate("world"):
                out.append(word)
            print(" ".join(out))  # -> HELLO WORLD!
        finally:
            await handle.stop()
    finally:
        await srv.stop()


if __name__ == "__main__":
    import asyncio

    asyncio.run(main())
