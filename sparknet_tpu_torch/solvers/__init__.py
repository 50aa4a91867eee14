from .lr_policies import learning_rate
from .step import make_step_fns
from .update_rules import SolverUpdate, make_update_rule, preprocess_grads
