"""The reference's examples on the port, each a module with a ``main``:
``python -m repro_torch.examples.<name>`` runs it on the card, ``--device
cpu`` on the CPU.  ``examples/repro_buffer_lifetime.py`` has no
counterpart: it shows JAX's buffer donation, which the port does not use
(its steps update their state in place)."""
