"""Process entry points: ``python -m minpaxos_tpu_torch.cli.{master,server,client}``.

The master, replica server and benchmark client binaries, with the JAX
package's flags; the server steps its replica on the card
(``-device cuda``, the default) or on the CPU (``-device cpu``).
"""
