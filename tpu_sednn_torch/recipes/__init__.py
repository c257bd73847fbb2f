from tpu_sednn_torch.recipes.finetune_nat import RecipeConfig, run_recipe, recipe_opt_schedule
