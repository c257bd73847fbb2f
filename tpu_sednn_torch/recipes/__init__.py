from tpu_sednn_torch.recipes.finetune_nat import RecipeConfig, run_recipe, recipe_opt_schedule
from tpu_sednn_torch.recipes.artifact import load_run_dir
