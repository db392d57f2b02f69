from cloudberry_tpu_torch.mgmt.cli import main

raise SystemExit(main())
