"""First-party Kubernetes API access: the port's copies of the stdlib
client (``client``), the asyncio I/O core (``aio``) and its synchronous
bridge (``aio_bridge``).

The mode engine's default flip path needs the bridge: its holder scan
runs overlapped on the bridge's event loop (``flipexec.submit_overlapped``).
The in-memory clientset (``fake``), the wire-level fake API server
(``apiserver``), the node objects and the write batcher come with the
controller slice of the port, so this package re-exports nothing yet.
"""
