"""The plain reference: NumPy and the standard library over the node
objects the benchmark made and the writes it sent. It imports nothing of
the program (``tpu_cc_manager_torch``)."""
