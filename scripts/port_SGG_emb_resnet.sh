#!/bin/sh
# Stage B on the PyTorch/CUDA port: relation (SGG) head training on the
# MVRD stills (JPEG), then eval (rel_det + recognition) on MVidVRD. The twin
# of scripts/SGG_emb_resnet.sh: the same flags, run as
# `python -m i2vsgg_tpu_torch.tools.*` on the card (add `--device cpu` to
# run on the CPU); --load_name is a Stage A checkpoint of the port's format.
cd "$(dirname "$0")/.."
vrd_lr=0.0001
max_epoch=10
session=1
num_relations=62
det_ckpt=models/res101/MVRD/session_${session}/$1   # pass the step as $1

python -m i2vsgg_tpu_torch.tools.trainval_sgg --net res101 --dataset MVRD \
    --vrd_lr $vrd_lr --epochs $max_epoch --s $session \
    --num_relations $num_relations \
    --source_gt_rels_path ./data/MVidVRD/source_gt_rels.pkl \
    --glove_path ./models/glove.6B.300d.txt \
    --predicate_file ./data/MVidVRD/predicates.json \
    --load_name $det_ckpt

last=$(ls models/res101/MVRD_SGG/session_${session} | sort | tail -1 | sed 's/step_//')
step=$((10#$last))

# relation detection + video association + vIoU metrics
python -m i2vsgg_tpu_torch.tools.test_sgg --net res101 --dataset MVidVRD \
    --num_relations $num_relations --vrd_task rel_det \
    --load_name models/res101/MVRD_SGG/session_${session}/$step \
    --video_ann ./data/MVidVRD/video_annotations.json

# recognition accuracy
python -m i2vsgg_tpu_torch.tools.test_sgg --net res101 --dataset MVidVRD \
    --num_relations $num_relations --vrd_task pre_det \
    --target_gt_rels_path ./data/MVidVRD/target_gt_rels.pkl \
    --source_so_prior_path ./data/MVidVRD/source_so_prior.pkl \
    --load_name models/res101/MVRD_SGG/session_${session}/$step
