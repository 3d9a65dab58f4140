"""``python -m warmup_fir_filter_tpu_torch`` runs the pipeline CLI."""

from warmup_fir_filter_tpu_torch.cli import main

raise SystemExit(main())
