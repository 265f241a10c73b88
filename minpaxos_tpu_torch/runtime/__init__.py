"""The TCP serving runtime: real processes over real TCP.

One process per replica (``replica.ReplicaServer``), a master for
registration, liveness and leader promotion (``master``), benchmark
clients speaking the framed wire protocol (``client``). Inside a
replica process one protocol thread drains sockets into fixed-shape
column batches and advances the replica with one packed step per
dispatch (k protocol substeps, their outputs packed on the device by
kernel K7 and read back in one copy).

Modules:

* batches   — frame rows <-> MsgBatch columns, the ingress coalescer
* stable    — append-only durable log + replay (checkpoint/resume)
* transport — peer mesh, client listener, handshake, reconnect
* replica   — the replica server process (event loop)
* master    — registration/ping/election service
* client    — benchmark client library (failover, -check)
"""
