"""Datalog° core: semirings, IR, dense engine, fixpoints, planner."""
