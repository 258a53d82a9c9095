"""The two-stage experiment sweep: config factories and the orchestrator
that runs the port's trainer and eval CLI as subprocesses."""
