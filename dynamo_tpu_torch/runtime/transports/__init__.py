"""Transports: the wire layer, copied from the JAX package's
``runtime/transports/`` so that the two packages' processes talk to each
other byte for byte.

  coordinator.py   the control plane: KV + leases + watches, pub/sub
                   subjects and durable work queues (the remote-prefill
                   queue rides these)
  framing.py       two-part frames: JSON header + raw payload
  net.py           the connection factory (real sockets)
  protocol.py      the op literals both sides put on the wire
  tcp.py           the request plane: an AsyncEngine served over one
                   duplex socket per client, multiplexed by request id
"""
