"""Protocol-scale drivers of the port (counterparts of the JAX package's
tools/ drivers of the same names): each builds its synthetic database,
generates what the protocol generates, and runs a dataset app's demo at
protocol size, restart-safe and in legs of growing `--iters`.

- `run_dtu_control`: demo1b on the synthetic DTU scan (3 views), held
  against the JAX package's committed run;
- `run_dtu_50k`: its 2-view twin, demo1a, on the same scan;
- `run_priorgen_50k`: LLFF demo1a on a visibility prior generated and
  checked against the scene's geometry;
- `run_realestate_50k`, `run_demo1a_200k`: RealEstate-10K's and LLFF's
  demo1a;
- `checkpoint_sweep`: test and QA of every saved checkpoint of a run;
- `evidence_snapshot`: a run's QA, configs and thinned scalars for
  committing.

Each runs as `python -m vipnerf_tpu_torch.protocol.<driver>`, on the first
GPU unless `--device cpu` is given.
"""
