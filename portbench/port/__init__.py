"""The benchmark's only contact with the program under test,
``quantized_tpu_torch``: one module per architecture builds its engine from
the benchmark's float parameters and names its units of work, and
``front`` builds the executor and the batcher that serve it."""
