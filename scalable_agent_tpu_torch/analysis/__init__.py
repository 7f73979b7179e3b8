"""The port's invariant analysis, after scalable_agent_tpu/analysis/.

For now it holds the runtime half only: `analysis.runtime`, the
`guarded_by` annotation and the lock-order checker behind `make_lock`
(`OrderedLock`, armed by `--lock_order_check` or the LOCK_ORDER_CHECK
environment variable). The static checkers (the contract lint and the
`guarded_by` AST pass) are ROADMAP A7.5.
"""
