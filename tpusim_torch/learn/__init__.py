"""tpusim_torch.learn — the learned-scoring lane (counterpart of
tpusim/learn/__init__.py).

Gradient-free tuning of the per-policy score weights over the lanes
replay: seeded antithetic OpenAI-ES (learn.es) and a diagonal CMA-ES
(learn.cma) propose continuous weight vectors, projected and deduplicated
onto the replays' i32 weights (learn.rollout), rolled out as one lanes
launch per generation, and scored on the paper's own metrics
(learn.objective). The generation loop (learn.loop, `tune`) keeps a
digest-signed resumable tuning log. The learned policy (learn.policy) is a
linear model over per-node features whose parameters are those weights;
learn.dataset teacher-forces a decision log (the `replay_forced` kernel)
for imitation (`imitate`).
"""

from tpusim_torch.learn.cma import DiagonalCMA  # noqa: F401
from tpusim_torch.learn.es import OpenAIES, centered_ranks  # noqa: F401
from tpusim_torch.learn.loop import (  # noqa: F401
    LOG_SCHEMA,
    ImitateConfig,
    TuneConfig,
    TuneResult,
    format_holdout_report,
    holdout_report,
    make_optimizer,
    project_theta,
    read_log,
    run_imitation,
    run_tune,
    write_log,
)
from tpusim_torch.learn.dataset import (  # noqa: F401
    ImitationPairs,
    TeacherReplay,
    feature_names_of,
    imitate_with_mining,
    load_teacher_log,
)
from tpusim_torch.learn.policy import (  # noqa: F401
    BUCKETED_FEATURES,
    FEATURE_SETS,
    LINEAR_FEATURES,
    POLICY_SCHEMA,
    learned_policies,
    load_policy_artifact,
    parse_policy_spec,
    policies_from_artifact,
    save_policy_artifact,
)
from tpusim_torch.learn.objective import (  # noqa: F401
    ObjectiveConfig,
    lane_terms,
    make_robust_eval,
    scalarize,
    terms_from_result,
    terms_from_simulate,
)
from tpusim_torch.learn.rollout import (  # noqa: F401
    LocalRollout,
    RemoteRollout,
    dedup_rows,
    make_family_sim,
    project_weights,
)
