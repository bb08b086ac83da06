"""Scenario API of the port: ``ScenarioConfig`` in, ``RunReport`` out."""
