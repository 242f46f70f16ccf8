from .cmd.main import main

raise SystemExit(main())
