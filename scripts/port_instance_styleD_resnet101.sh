#!/bin/sh
# Stage A on the PyTorch/CUDA port: adversarial DA detector training on the
# MVRD stills (JPEG) -> MVidVRD, then the per-epoch eval loop. The twin of
# scripts/instance_styleD_resnet101.sh: the same flags, run as
# `python -m i2vsgg_tpu_torch.tools.*` on the card (add `--device cpu` to
# run on the CPU). Checkpoints are the port's format.
cd "$(dirname "$0")/.."
lr=0.0005
lr_decay_step=10
lr_decay_gamma=0.1
max_epoch=10
eta=0.1
eta_style=0.001
style_lambda=1
bs=1
session=1
pretrained=./data/pretrained_model/resnet101_coco.pth   # torch .pth

run_name=MVRD_MVidVRD_ins_pix_styD_lr${lr}_eta${eta}_sty${style_lambda}_bs${bs}
mkdir -p ./log/$run_name

python -m i2vsgg_tpu_torch.tools.trainval_det_da --net res101 --dataset MVRD --dataset_t MVidVRD \
    --use_tfb --tfb_path ./log/$run_name \
    --lr $lr --lr_decay_step $lr_decay_step --lr_decay_gamma $lr_decay_gamma \
    --eta $eta --eta_style $eta_style --style_lambda $style_lambda --bs $bs \
    --epochs $max_epoch --s $session --ic --gc \
    --pretrained_backbone $pretrained \
    2>&1 | tee ./log/$run_name/train.log

# eval every epoch checkpoint (the reference's test loop)
for step_dir in models/res101/MVRD/session_${session}/step_*; do
    step=$((10#$(basename $step_dir | sed 's/step_//')))
    python -m i2vsgg_tpu_torch.tools.test_det --net res101 --dataset MVidVRD --ic --gc \
        --load_name models/res101/MVRD/session_${session}/$step \
        2>&1 | tee -a ./log/$run_name/test.log
done
