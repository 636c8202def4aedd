"""Deployments by name: ``deploy(config, device)`` builds the app of a
configuration on ``device`` and returns a ``harness.Deployed``."""
