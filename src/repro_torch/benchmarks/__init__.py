"""The paper's figure scripts on the port, named after the reference's
``benchmarks/`` files.  Each prints ``name,us_per_call,derived`` rows and
asserts the claims the reference asserts; modeled rows are the
reference's, letter for letter.  They run on the card unless given
``device="cpu"``; ``python -m repro_torch.benchmarks.run`` drives the
figures."""
