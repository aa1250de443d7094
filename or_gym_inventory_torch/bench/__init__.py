"""The benchmark harness (port of ``or_gym_inventory_tpu/bench``): seeded
evaluation on the host and on the device, aggregation and persistence, the
plots, ``runner.run_benchmark`` and the ten reference protocols
(``protocols``)."""

from or_gym_inventory_torch.bench.evaluate import evaluate_agent, evaluate_agent_vectorized  # noqa: F401
from or_gym_inventory_torch.bench.report import process_and_report_results, numpy_encoder  # noqa: F401
from or_gym_inventory_torch.bench import plots  # noqa: F401
