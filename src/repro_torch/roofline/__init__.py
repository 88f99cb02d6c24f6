"""The roofline report's pieces: analytic parameter and model-FLOP counts
and the three roofline terms (:mod:`.analysis`), the work a step does as
counted while it runs (:mod:`.counter`: FLOPs and bytes accessed per op,
and the kernels' own counts), and the collective bytes its calls issue
(:mod:`.collectives`). ``launch/dryrun.py`` writes the records and
``benchmarks/torch_roofline.py`` reads them."""
