"""Master recovery and fault handling: query-log replay, ``recover_master``,
heartbeats, stragglers, and the deterministic fault injector with its
virtual clock."""
