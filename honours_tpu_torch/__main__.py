from honours_tpu_torch.cli import main

raise SystemExit(main())
