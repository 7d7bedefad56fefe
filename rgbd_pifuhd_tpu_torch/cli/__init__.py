"""Command-line entry points of the port: ``run_recon`` (batch) and
``serve`` (resident server)."""
