"""Lock helpers of the runtime, in the form the reference runs in
production (``siddhi_tpu/analysis/``: ``make_lock``, ``guarded``). The
checked lock, the lock-order table and the sanitizer are ROADMAP A.10."""
